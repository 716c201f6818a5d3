"""ppnp_tpu_torch: the PyTorch + CUDA port of ``ppnp_tpu`` for one NVIDIA H100.

The JAX package ``ppnp_tpu`` stays the reference; this package mirrors its
module names so each counterpart is found by name, and never imports jax or
any module of ``ppnp_tpu`` (it keeps its own copies of the numpy parts).

Ported so far: the serving path, ``python -m ppnp_tpu_torch predict``
(checkpoint restore → graph load → Â → propagator → eval forward: MLP →
K-step APPNP → log-softmax → argmax), and training,
``python -m ppnp_tpu_torch train`` (``train.train_model``: the JAX key
schedule and dropout masks bit for bit, K1's backward and K3's adjoint,
optax's Adam, early stopping, checkpoints). The hand-written CUDA kernels
live in ``ppnp_tpu_torch/kernels`` (sources in ``ppnp_tpu_torch/csrc``) and
build with ``nvcc`` at first use on the card; nothing is compiled or
imported from CUDA when this package is imported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (``ppnp_tpu_torch.device``).
"""

from ppnp_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
