"""The serving half of ``ppnp_tpu/train.py``: ``prepare_attr_input`` and
``get_predictions``.

``train_model`` (Adam, early stopping, dropout) comes with the training
slice (ROADMAP.md, "Still to port", item 1: Training).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ppnp_tpu_torch import preprocessing
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.models.appnp import MLP, ppnp_forward
from ppnp_tpu_torch.ops.sparse import csr_from_scipy
from ppnp_tpu_torch.ops.sparse_input import SparseInput

__all__ = ["get_predictions", "prepare_attr_input", "BF16_TODO"]

BF16_TODO = ("x_dtype=bfloat16 is not ported yet (ROADMAP.md, \"Still to "
             "port\", item 7: bfloat16 attributes)")


def prepare_attr_input(graph: SparseGraph, propagator, *,
                       x_format: str = "auto", x_dtype=None):
    """L1-normalize the attribute matrix and stage it on the propagator's
    device, dense or as a ``SparseInput`` (fc1 through K1).

    ``x_format``: "dense" densifies X (fc1 is then one f32
    ``torch.matmul``); "sparse" keeps it CSR; "auto" picks sparse exactly
    when X is scipy-sparse, its dense form has at least 16 M entries
    (n·f ≥ 16,000,000) and at most 5 % of them are nonzero. This is the
    JAX rule (``ppnp_tpu/train.py:209-218``) without its VMEM term, which
    describes the TPU's on-chip memory and means nothing on this card. On
    the four surrogates it chooses as the JAX rule does: sparse only for
    ms_academic (n·f = 124.7 M at 0.12 % density).

    ``x_dtype``: ``None``/float32 only; bfloat16 raises for now.
    """
    if x_dtype not in (None, "float32", torch.float32):
        raise NotImplementedError(BF16_TODO)
    attr_norm = preprocessing.normalize_attributes(graph.attr_matrix)
    device = propagator.device
    n, f = attr_norm.shape
    if x_format == "auto":
        use_sparse = (sp.issparse(attr_norm) and n * f >= 16_000_000
                      and attr_norm.nnz <= 0.05 * n * f)
    elif x_format in ("dense", "sparse"):
        use_sparse = x_format == "sparse"
    else:
        raise ValueError(f"unknown x_format {x_format!r} "
                         "(expected 'auto', 'dense' or 'sparse')")
    if use_sparse:
        return SparseInput(csr=csr_from_scipy(attr_norm, device=device))
    x_np = (np.asarray(attr_norm.todense(), dtype=np.float32)
            if sp.issparse(attr_norm)
            else np.asarray(attr_norm, dtype=np.float32))
    return torch.from_numpy(x_np).to(device)


def get_predictions(model: MLP, x, propagator) -> np.ndarray:
    """Argmax class predictions for all nodes (eval mode).

    Dense fc1 runs in full float32: TF32 matmuls are switched off here
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)
    so the card computes what the JAX reference computes at f32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logp = ppnp_forward(model, x, propagator, None, train=False)
        return logp.argmax(dim=-1).cpu().numpy()
