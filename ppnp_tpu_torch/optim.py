"""Adam with ``optax.adam``'s defaults and arithmetic order.

``torch.optim.Adam`` orders its operations differently (it folds the bias
corrections into the step size and adds eps to a corrected square root),
so its updates differ from the JAX package's in the last bits, and over
hundreds of epochs an early-stopping decision can flip. This update
follows ``optax.scale_by_adam`` + ``scale_by_learning_rate``
(b1 = 0.9, b2 = 0.999, eps = 1e-8, eps_root = 0) in float32:

    mu  = (1 - b1)·g + b1·mu
    nu  = (1 - b2)·g² + b2·nu
    t   = t + 1                       (int32 count)
    m̂   = mu / (1 - b1^t),  v̂ = nu / (1 - b2^t)   (f32 power, host)
    p   = p + (-lr)·(m̂ / (√v̂ + eps))

The f32 power ``b^t`` may differ from XLA's by one unit in the last place;
everything else rounds as optax does.

``step(grads, mask=...)`` is the seed-batched update of
``ppnp_tpu/multiseed.py::_mask_tree``: parameters stacked along a leading
G axis, and seeds whose ``mask`` entry is False keep their parameters and
moments. The shared count advances on every step, as it does there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Adam"]


class Adam:
    """Adam over a list of parameter tensors, updated in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float = 0.01,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _correction(self, b: float) -> float:
        # 1 - b^t in float32 on the host: the card never waits for it
        return float(np.float32(1) - np.float32(b) ** np.float32(self.count))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             mask: Optional[torch.Tensor] = None) -> None:
        """One update with ``grads`` (one per parameter). With ``mask``, a
        (G,) bool tensor over every parameter's leading axis, only the
        entries where it is True change."""
        self.count = min(self.count + 1, 2 ** 31 - 1)
        c1, c2 = self._correction(self.b1), self._correction(self.b2)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            new_mu = (1 - self.b1) * g + self.b1 * mu
            new_nu = (1 - self.b2) * (g * g) + self.b2 * nu
            m_hat, v_hat = new_mu / c1, new_nu / c2
            new_p = p + (-self.lr) * (m_hat / (torch.sqrt(v_hat) + self.eps))
            if mask is not None:
                keep = mask.view((-1,) + (1,) * (p.dim() - 1))
                new_mu = torch.where(keep, new_mu, mu)
                new_nu = torch.where(keep, new_nu, nu)
                new_p = torch.where(keep, new_p, p)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
            p.copy_(new_p)

    def state_dict(self) -> Dict[str, Any]:
        """``{count, mu, nu}`` on the CPU (``optax``'s ScaleByAdamState)."""
        return {"count": self.count,
                "mu": [t.detach().cpu() for t in self.mu],
                "nu": [t.detach().cpu() for t in self.nu]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            src: List[torch.Tensor] = state[key]
            for d, s in zip(dst, src):
                d.copy_(s)
