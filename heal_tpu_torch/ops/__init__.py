"""Device-side operators (torch), with the four hand-written CUDA kernels.

``pillar.pillar_tables``, ``shift_rows.shift_rows``,
``column_conv.column_conv_layer`` and
``window_attention.window_attention`` launch CUDA kernels for CUDA tensors
and take their plain PyTorch versions for CPU tensors.
"""
