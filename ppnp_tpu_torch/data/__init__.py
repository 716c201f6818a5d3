"""Data layer: graph container, npz IO, dataset registry, synthetic graphs.

The port's own copies of ``ppnp_tpu/data``: numpy/scipy only.
"""

from ppnp_tpu_torch.data.sparsegraph import SparseGraph  # noqa: F401
from ppnp_tpu_torch.data.io import load_from_npz, save_to_npz  # noqa: F401
from ppnp_tpu_torch.data.datasets import load_dataset  # noqa: F401
