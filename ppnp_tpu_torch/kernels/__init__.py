"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- ``spmm``: K1, ``A_w @ H (+ init)`` over CSR (port of
  ``ppnp_tpu/kernels/spmm.py::_spmm_kernel``);
- ``fused``: K3, K APPNP steps in one cooperative launch (port of
  ``ppnp_tpu/kernels/fused.py::_fused_kernel``, forward mode);
- ``build``: nvcc build, ctypes loading and launch counts.

Importing this package compiles and loads nothing.
"""
