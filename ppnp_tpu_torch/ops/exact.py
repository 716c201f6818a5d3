"""Exact PPNP: the dense personalized-PageRank matrix Π = α(I − (1−α)Â)⁻¹.

The port of ``ppnp_tpu/ops/exact.py`` (``calc_ppr_exact``, ``PPRExact``).
Π comes from ``torch.linalg.solve(I − (1−α)Â, α·I)`` on the operator's
device, a library call as it is in the JAX package, which also computes
it outside Pallas. M = I − (1−α)Â is formed in float32 on the host from
Â's triplets, as the JAX package forms it, and expanded to dense on the
device, so only the triplets cross to the card.

``method`` keeps the JAX names: "solve", "newton" (Newton–Schulz,
X ← 2X − X(MX), matmuls only) and "auto". On the TPU "auto" switched to
Newton at n ≥ 4096 and selected Π's rows with one-hot products above
n = 8192 (``exact.py:42-49``, ``185-214``), both to dodge XLA:TPU compile
limits; here "auto" is "solve" at every size and rows are selected with
``index_select``.

Train mode applies ``ops/dropout.dropout`` to the SELECTED Π rows
(``dropout(Π[idx]) @ H``, the reference's order), so its masks are the
JAX package's bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ppnp_tpu_torch.device import resolve_device
from ppnp_tpu_torch.ops.dropout import dropout

__all__ = ["calc_ppr_exact", "PPRExact", "newton_schulz_iters"]

METHODS = ("auto", "solve", "newton")


def newton_schulz_iters(alpha: float, eps: float = 1e-7) -> int:
    """Iterations until the Newton residual (1−α)^(2^k) < eps."""
    r0 = max(1e-6, 1.0 - alpha)
    return max(1, math.ceil(math.log2(math.log(eps) / math.log(r0))) + 1)


def _dense_m(a_hat, alpha: float, device: torch.device) -> torch.Tensor:
    """M = I − (1−α)Â, float32, dense on ``device``."""
    if sp.issparse(a_hat):
        n = a_hat.shape[0]
        m_sp = (sp.identity(n, dtype=np.float32, format="csr")
                - np.float32(1.0 - alpha) * a_hat.tocsr()).tocoo()
        m_sp.sum_duplicates()
        m = torch.zeros((n, n), dtype=torch.float32, device=device)
        rows = torch.from_numpy(m_sp.row.astype(np.int64)).to(device)
        cols = torch.from_numpy(m_sp.col.astype(np.int64)).to(device)
        vals = torch.from_numpy(m_sp.data.astype(np.float32)).to(device)
        return m.index_put_((rows, cols), vals)
    a = torch.as_tensor(np.asarray(a_hat, dtype=np.float32), device=device)
    return torch.eye(a.shape[0], dtype=torch.float32, device=device) \
        - (1.0 - alpha) * a


def calc_ppr_exact(a_hat: Union[sp.spmatrix, np.ndarray], alpha: float,
                   method: str = "auto", device=None) -> torch.Tensor:
    """Dense Π = α·(I − (1−α)Â)⁻¹, float32 (n, n) on ``device`` (default
    cuda). ``method``: "solve" (LU), "newton" (Newton–Schulz), "auto"
    (= "solve")."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (expected 'auto', "
                         "'solve' or 'newton')")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    m = _dense_m(a_hat, alpha, dev)
    n = m.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    if method in ("auto", "solve"):
        return torch.linalg.solve(m, alpha * eye)
    x = eye
    for _ in range(newton_schulz_iters(alpha)):
        x = 2.0 * x - x @ (m @ x)
    return alpha * x


class PPRExact(nn.Module):
    """Exact-PPNP propagation: Z = dropout(Π[idx]) @ H_local."""

    def __init__(self, ppr: torch.Tensor, drop_prob: float = 0.5):
        super().__init__()
        if ppr.dim() != 2 or ppr.shape[0] != ppr.shape[1] \
                or ppr.dtype != torch.float32:
            raise ValueError(f"PPRExact: ppr must be square float32, got "
                             f"{tuple(ppr.shape)} {ppr.dtype}")
        self.ppr = ppr
        self.drop_prob = float(drop_prob)

    @property
    def device(self) -> torch.device:
        return self.ppr.device

    def forward(self, h_local: torch.Tensor,
                idx: Optional[torch.Tensor] = None, *, key=None,
                train: bool = False) -> torch.Tensor:
        """``dropout(Π[idx]) @ h_local`` (all rows when ``idx`` is None;
        dropout only in train mode with a key)."""
        rows = self.ppr if idx is None else self.ppr.index_select(0, idx)
        if train and self.drop_prob > 0.0 and key is not None:
            rows = dropout(key, rows, self.drop_prob)
        return rows @ h_local

    def propagate(self, h0: torch.Tensor, *, key=None,
                  train: bool = False) -> torch.Tensor:
        """Full-table propagation: Π @ H⁰."""
        return self(h0, None, key=key, train=train)
