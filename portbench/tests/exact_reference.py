"""A reference for exact PPNP, which a configuration names by path: the
eval forward of every node with the dense float64
Π = α(I − (1−α)Â)⁻¹, by ``torch.linalg.solve``, times the logits of
``portbench.reference``'s MLP. Π is solved once a problem and α, on
the problem's device. Plain PyTorch: it imports nothing of the program,
and takes Â, X and the MLP from ``portbench.reference``.

Serving cells only: exact PPNP's training steps (dropout on the rows of
Π that an epoch gathers) are not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import reference as base
from portbench.reference import leaf_gaps  # noqa: F401  (the interface)

__all__ = ["prepare", "train_steps", "eval_logp", "leaf_gaps", "ppr"]


def prepare(adj, attr, labels, *, arm=None, **kwargs) -> base.Problem:
    """``portbench.reference.prepare`` of the CSR arms: Π has no edge
    ids, so the mix names none (``arm`` None) and the RCM ids go
    unused."""
    return base.prepare(adj, attr, labels, arm="rcm", **kwargs)


def ppr(p: base.Problem, alpha: float) -> torch.Tensor:
    """Dense float64 Π of the problem's Â, kept on the problem for the
    last α asked."""
    held = getattr(p, "exact_ppr", None)
    if held is None or held[0] != alpha:
        p.exact_ppr = None  # the old Π goes before the new is solved
        m = torch.eye(p.n, dtype=torch.float64, device=p.device)
        m.index_put_((p.a_rows, p.a_cols), -(1.0 - alpha) * p.a_val,
                     accumulate=True)
        rhs = alpha * torch.eye(p.n, dtype=torch.float64, device=p.device)
        pi = torch.linalg.solve(m, rhs)
        del m, rhs
        p.exact_ppr = held = (alpha, pi)
    return held[1]


def eval_logp(p: base.Problem, w1, w2, *, alpha: float, niter=None,
              precision: str = "float64", fault=None) -> torch.Tensor:
    """Log-probabilities of every node, eval mode: ``log_softmax(Π · H⁰)``
    with H⁰ the MLP's logits; ``precision="tf32"`` rounds Π and H⁰ to
    TF32 and multiplies in float32 (the control). ``niter`` is unused."""
    if fault is not None:
        raise ValueError(f"no fault {fault!r} in the exact reference")
    m = base._Math(precision)
    with torch.no_grad():
        h0 = base._local_logits(p, m, m.r(w1.to(p.device)),
                                m.r(w2.to(p.device)), None, 0.0)
        z = m.mm(ppr(p, alpha), h0)
        return F.log_softmax(z, dim=-1).to(torch.float64)


def train_steps(*args, **kwargs):
    raise NotImplementedError("exact PPNP's training steps are not in this "
                              "reference: it serves serving cells only")
