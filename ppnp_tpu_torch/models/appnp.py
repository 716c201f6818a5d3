"""The PPNP/APPNP model: an MLP producing local predictions, then a
propagation operator, then log-softmax.

Counterpart of ``ppnp_tpu/models/appnp.py``. The JAX package keeps its
parameters as a list of ``(d_in, d_out)`` weight matrices; the port keeps
them in an ``MLP`` module of bias-free ``nn.Linear`` layers, whose weights
are ``(d_out, d_in)``. ``params_from_jax`` converts the former into the
latter, so both packages can compute the same thing from the same
weights, and ``init_mlp_params(key=...)`` draws the JAX package's initial
weights from the same key.

Train mode draws the JAX package's dropout masks from the same keys
(``ops/prng.py``): ``ppnp_forward`` splits its key into (MLP,
propagation), ``mlp_forward`` splits the MLP key per layer; dropout
precedes every layer, id-keyed on X's values when X is sparse.

Under a row-sharded propagator the MLP runs on this rank's rows
``[lo, hi)`` of X (the propagator's ``row_range``), with the weights
replicated on every rank: each dense dropout draws rows ``[lo, hi)`` of
the mask JAX draws over the whole padded array (``row_offset`` = lo), and
a ``ShardedSparseInput`` draws its own rank's planes.

A dense X narrower than the weights (``x_dtype=bfloat16``) takes the
mixed-precision fc1 of ``ops/mixed.py``: bf16 operands, f32 sums and
output, the weight gradient rounded to bf16 as JAX rounds it
(``appnp.py:75-91``). Under a row-sharded propagator that rounding is left
to the caller, after the ranks' parts are summed (``train.loss_and_grads``).
The forward is labelled for traces as the JAX package labels it:
``ppnp/mlp`` and ``ppnp/propagate`` (``profiling.annotate``).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import dropout
from ppnp_tpu_torch.ops.mixed import mixed_matmul
from ppnp_tpu_torch.ops.sparse_input import SparseInput
from ppnp_tpu_torch.profiling import annotate

__all__ = ["MLP", "init_mlp_params", "params_from_jax", "mlp_forward",
           "ppnp_forward", "l2_reg"]


class MLP(nn.Module):
    """fc₁ → ReLU → … → fc_last, bias-free (the reference's layer stack).

    The first layer also takes a ``SparseInput`` X, through K1.
    """

    def __init__(self, dims: Sequence[int], device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(d_in, d_out, bias=False, device=device)
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor],
                        device=None) -> "MLP":
        """An MLP shaped and filled from ``state_dict()`` output."""
        weights = [state[f"layers.{i}.weight"] for i in range(len(state))]
        dims = [weights[0].shape[1]] + [w.shape[0] for w in weights]
        model = cls(dims, device=device)
        model.load_state_dict(state)
        return model

    def forward(self, x, *, key=None, train: bool = False,
                drop_prob: float = 0.5, row_offset: int = 0,
                round_dw: bool = True) -> torch.Tensor:
        """Local logits; in train mode dropout (from ``key``) precedes
        every layer (``ppnp_tpu/models/appnp.py:50-96``). ``x`` holds the
        rows from ``row_offset`` on of the whole (padded) X; a narrower
        dense X takes the mixed fc1, whose weight gradient is rounded to
        X's dtype unless ``round_dw`` is False (module docstring)."""
        use_drop = bool(train and drop_prob > 0.0 and key is not None)
        n_layers = len(self.layers)
        keys = prng.split(key, n_layers) if use_drop else None
        h = x
        for i, lin in enumerate(self.layers):
            if i == 0 and isinstance(x, SparseInput):
                h = x.matmul(lin.weight.t(),
                             key=keys[0] if use_drop else None,
                             train=train, drop_prob=drop_prob)
            else:
                if use_drop:
                    h = dropout(keys[i], h, drop_prob,
                                row_offset=row_offset)
                h = _linear(h, lin.weight, round_dw)
            if i < n_layers - 1:
                h = F.relu(h)
        return h


def _linear(h: torch.Tensor, weight: torch.Tensor,
            round_dw: bool) -> torch.Tensor:
    """``h @ weightᵀ``: mixed precision for narrower data; the inverted
    case (weights narrower than the data) upcasts the weights, so
    precision is never lost silently (``appnp.py:86-90``)."""
    if h.dtype == weight.dtype:
        return F.linear(h, weight)
    if torch.finfo(h.dtype).bits < torch.finfo(weight.dtype).bits:
        return mixed_matmul(h, weight.t(), round_dw=round_dw)
    return F.linear(h, weight.to(h.dtype))


def init_mlp_params(n_features: int, hidden_units: Sequence[int],
                    n_classes: int, *, key=None,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> MLP:
    """Glorot-uniform weights for [n_features, *hidden_units, n_classes]
    on ``device`` (default cuda).

    With ``key`` (a (2,) uint32 key, ``ops/prng.py``) the weights are
    those of ``ppnp_tpu.models.appnp.init_mlp_params(key, ...)`` bit for
    bit: ``split(key, n_layers)`` and one ``glorot_uniform`` per layer.
    Otherwise they are drawn on the CPU from ``generator`` (so a seed
    gives the same weights on every device), not bit-equal to
    ``jax.random``.
    """
    dev = resolve_device(device)
    dims = [n_features, *hidden_units, n_classes]
    if key is not None:
        keys = prng.split(key, len(dims) - 1)
        return params_from_jax(
            [prng.glorot_uniform(k, (d_in, d_out))
             for k, d_in, d_out in zip(keys, dims[:-1], dims[1:])],
            device=dev)
    model = MLP(dims)
    with torch.no_grad():
        for lin in model.layers:
            d_out, d_in = lin.weight.shape
            limit = math.sqrt(6.0 / (d_in + d_out))
            lin.weight.uniform_(-limit, limit, generator=generator)
    return model.to(dev)


def params_from_jax(params: Sequence[np.ndarray], device=None) -> MLP:
    """The JAX package's ``[W₁ (f×h), …, W_last (h×c)]`` as an ``MLP``."""
    dev = resolve_device(device)
    mats = [np.asarray(w, dtype=np.float32) for w in params]
    dims = [mats[0].shape[0]] + [w.shape[1] for w in mats]
    model = MLP(dims)
    with torch.no_grad():
        for lin, w in zip(model.layers, mats):
            lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
    return model.to(dev)


def mlp_forward(model: MLP, x, *, key=None, train: bool = False,
                drop_prob: float = 0.5, row_offset: int = 0,
                round_dw: bool = True) -> torch.Tensor:
    """Local (pre-propagation) logits H_local for all n nodes (for the
    rows of X from ``row_offset`` on)."""
    return model(x, key=key, train=train, drop_prob=drop_prob,
                 row_offset=row_offset, round_dw=round_dw)


def ppnp_forward(model: MLP, x, propagator,
                 idx: Optional[torch.Tensor] = None, *, key=None,
                 train: bool = False, drop_prob: float = 0.5
                 ) -> torch.Tensor:
    """Full PPNP forward: MLP → propagate → select idx → log_softmax,
    with ``key_mlp, key_prop = split(key)`` (``appnp.py:104-107``). A
    row-sharded propagator's ``row_range`` places this rank's rows of X
    in the whole array (and leaves a mixed fc1's rounding of dW to the
    caller)."""
    if key is not None:
        key_mlp, key_prop = prng.split(key)
    else:
        key_mlp = key_prop = None
    sharded = hasattr(propagator, "row_range")
    lo = propagator.row_range[0] if sharded else 0
    with annotate("ppnp/mlp"):
        h_local = mlp_forward(model, x, key=key_mlp, train=train,
                              drop_prob=drop_prob, row_offset=lo,
                              round_dw=not sharded)
    with annotate("ppnp/propagate"):
        z = propagator(h_local, idx, key=key_prop, train=train)
    return F.log_softmax(z, dim=-1)


def l2_reg(model: MLP) -> torch.Tensor:
    """Σ‖W_fc1‖² — the reference regularizes the first layer only."""
    return torch.sum(model.layers[0].weight ** 2)
