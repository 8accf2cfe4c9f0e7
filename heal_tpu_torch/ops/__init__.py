"""Device-side operators (torch), with the three hand-written CUDA kernels.

``pillar.pillar_tables``, ``shift_rows.shift_rows`` and
``column_conv.column_conv_layer`` launch CUDA kernels for CUDA tensors and
take their plain PyTorch versions for CPU tensors.
"""
