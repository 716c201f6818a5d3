"""ppnp_tpu_torch: the PyTorch + CUDA port of ``ppnp_tpu`` for one NVIDIA H100.

The JAX package ``ppnp_tpu`` stays the reference; this package mirrors its
module names and its public names, so each counterpart is found by name,
and never imports jax or any module of ``ppnp_tpu`` (it keeps its own
copies of the numpy parts).

It does what ``ppnp_tpu`` does but the TPU-only parts (ROADMAP "Not to
port"): data, Â and splits; APPNP, PPNP and exact PPNP; ``predict``,
``train``, ``reproduce`` (the seed-batched sweep), ``retrieve`` and
``bench`` (``python -m ppnp_tpu_torch``, or the ``ppnp-tpu-torch``
script) on the xla, pallas, fused and blocked arms; the row-sharded and
hierarchical paths over ``torch.distributed``; bfloat16 attributes and
tracing. ``examples/simple_example_torch.py`` is the paper's run through
the public names below and those of ``ppnp_tpu_torch.ops``, ``.models``,
``.parallel`` and ``.kernels``.

The hand-written CUDA kernels live in ``ppnp_tpu_torch/kernels`` (sources
in ``ppnp_tpu_torch/csrc``) and build with ``nvcc`` at first use on the
card; nothing is compiled or loaded when this package is imported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises (``ppnp_tpu_torch.device``).
"""

__version__ = "0.1.0"

from ppnp_tpu_torch.device import resolve_device  # noqa: F401
from ppnp_tpu_torch.data.sparsegraph import SparseGraph  # noqa: F401
from ppnp_tpu_torch.data.datasets import load_dataset  # noqa: F401
