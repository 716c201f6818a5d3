"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

- ``spmm``: K1, ``A_w @ H (+ init)`` over CSR, and its backward on the
  CSR of Aᵀ (port of ``ppnp_tpu/kernels/spmm.py::_spmm_kernel``);
- ``fused``: K3, K APPNP steps in one cooperative launch of persistent
  row bands that wait on each other through per-band ready flags, forward
  and adjoint mode (port of ``ppnp_tpu/kernels/fused.py::_fused_kernel``);
- ``masks``: the training path's dropout masks, drawn on the card as
  ``ppnp_tpu/ops/dropout.py`` draws them;
- ``blocked``: K1 over the RCM row blocks of the blocked arm
  (``spmm_blocked``, the counterpart of ``ppnp_tpu/kernels/blocked.py``);
- ``build``: nvcc build, ctypes loading and launch counts.

Importing this package compiles and loads nothing.
"""

from ppnp_tpu_torch.kernels.blocked import spmm_blocked  # noqa: F401
