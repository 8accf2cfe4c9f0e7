"""Device-side operators (torch), with the two hand-written CUDA kernels.

``pillar.pillar_tables`` and ``shift_rows.shift_rows`` launch CUDA kernels
for CUDA tensors and take their plain PyTorch versions for CPU tensors.
"""
