"""Operations and bytes from shapes, and the card's peaks.

Every count is what the algorithm needs, whatever a kernel does: a
sparse product ``2·nnz·c`` operations, a dense one ``2·m·k·n``, and the
K-step propagation reads its inputs once (Â's pattern and values, H⁰)
and writes its output once. Its edge-dropout masks are integer work,
not bytes: each kept-or-dropped decision is one Threefry draw, which a
design may compute where it multiplies and never store, so the least
time counts the draws' instructions at the card's issue rate
(``chip_smoke.py``'s bound) and no mask planes. Arms and kernels that
do more work than this read a lower share; none can read above 100 %.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PEAK_F32_FLOPS", "PEAK_HBM_BYTES_PER_S", "PEAK_ISSUE_OPS",
           "DRAW_INT_OPS", "Shapes",
           "epoch_flops", "request_flops", "propagation_least_s"]

# NVIDIA H100 SXM data sheet, at its 700 W limit: float32 outside the
# tensor cores (the port runs f32 with TF32 off), and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# instruction issue: one warp instruction a sub-partition a clock, 132 SMs
# x 4 x 32 lanes x 1.98 GHz (copied from chip_smoke.py's ISSUE_OPS)
PEAK_ISSUE_OPS = 33.4e12
# 32-bit integer instructions of one edge-mask draw (the first Threefry
# word), both pipes together, in the SASS nvcc builds for sm_90a
# (chip_smoke.py's DRAW_FIRST, 47 + 16)
DRAW_INT_OPS = 63


@dataclasses.dataclass(frozen=True)
class Shapes:
    """One model's shapes: n nodes, Â's nnz, f features (X's nnz when X
    is sparse), hidden width, c classes, K steps, G models at once, and
    the propagation the model runs: ``"power"`` (APPNP's K steps, which
    the counts below are of) or ``"exact"`` (PPNP's dense Π; K is 0, and
    a reader of such a cell counts Π's work itself)."""
    n: int
    nnz: int
    f: int
    nnz_x: int
    hidden: int
    c: int
    niter: int
    x_sparse: bool
    groups: int = 1
    propagation: str = "power"


def _fc1(s: Shapes) -> float:
    return 2.0 * (s.nnz_x if s.x_sparse else s.n * s.f) * s.hidden


def _forward(s: Shapes) -> float:
    return (_fc1(s) + 2.0 * s.n * s.hidden * s.c
            + s.niter * 2.0 * s.nnz * s.c)


def epoch_flops(s: Shapes) -> float:
    """One training epoch: forward, backward (the propagation's adjoint,
    both products of the second layer, fc1's weight gradient) and the
    stopping-set eval forward, for each of the G models."""
    backward = (s.niter * 2.0 * s.nnz * s.c + 2 * 2.0 * s.n * s.hidden * s.c
                + _fc1(s))
    return s.groups * (2 * _forward(s) + backward)


def request_flops(s: Shapes) -> float:
    """One eval forward over every node."""
    return s.groups * _forward(s)


def propagation_least_s(s: Shapes, train: bool) -> float:
    """Least time of one K-step propagation of the G models' stacked H:
    max(bytes / HBM bandwidth, operations / f32 peak, mask draws'
    integer instructions / issue rate). Both modes read Â's pattern and
    values once; train mode draws one mask decision an entry a step a
    model (K·G·nnz draws)."""
    lanes = s.groups * s.c
    nbytes = 4.0 * ((s.n + 1) + 2 * s.nnz + 2 * s.n * lanes)
    flops = s.niter * 2.0 * s.nnz * lanes
    draws = s.niter * s.groups * s.nnz if train else 0
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS,
               draws * DRAW_INT_OPS / PEAK_ISSUE_OPS)
