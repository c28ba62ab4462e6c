"""Hand-written Hopper kernels of the port and their plain versions.

``attention.py`` holds the wrappers (chunk attention, fused paged decode,
the flash-attention backward's dq and dk/dv) and ``flash_attention``, the
autograd function over them; ``ref.py`` the float32 plain versions the CPU
runs and the kernels are held against, ``_build.py`` the nvcc build, and
``csrc/`` the CUDA sources.
"""
