"""Device-side sparse formats for the propagation SpMM.

Counterpart of ``ppnp_tpu/ops/sparse.py`` plus the RCM permutation of
``ppnp_tpu/ops/pairchunks.py::rcm_permutation``.

``EdgeList`` — destination-sorted COO ``(dst, src, w)`` padded to a
multiple of 512 exactly as the JAX package pads it, for the ``xla`` arm
(gather + ``index_add_``, no kernel). The padding keeps the slot count
equal to the reference's, which its slot-ordered dropout masks depend on.

``CsrMatrix`` — the operator of the hand-written kernels (``pallas`` and
``fused`` arms, sparse fc1): ``row_ptr``/``col`` int32, ``val`` f32, built
on the host. A square operator is built under the SAME reverse
Cuthill-McKee permutation the JAX builders pack with
(``ppnp_tpu/builders.py``), so packed coordinates — and with them the
canonical edge id ``row·span + col`` — line up. The port does not keep
the TPU's PairChunks layout: it existed to turn gather and scatter into
one-hot MXU matmuls, and a CUDA kernel gathers directly.

Edge ids (``ppnp_tpu/ops/pairchunks.py:779-807``): an entry at (r, c) of
a forward matrix is edge ``r·span + c``, with ``span`` = max(n_rows,
n_cols) of the forward matrix (n for Â after RCM, max(n, f) for X). The
backward's operator is the CSR of the transpose (``csr_transpose``); its
entry at (r, c) is edge ``c·span + r``, the id of the same edge in the
forward matrix (``transpose_ids``, ``pairchunks.py:823-831``). Ids are
computed from (row, col) where they are needed; none is stored. What
the builders do store for the mask kernel is each entry's row (``rows``,
so a thread finds its entry's id without a search of ``row_ptr``) and,
on a transpose, the position map between the two layouts: entry j of Aᵀ
is entry ``fwd_pos[j]`` of A, the same edge with the same value, so the
mask kernel draws each edge once and fills Aᵀ's planes through the map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ppnp_tpu_torch.device import resolve_device

__all__ = ["EdgeList", "edge_list_from_scipy", "CsrMatrix",
           "csr_from_scipy", "csr_transpose", "rcm_permutation"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Destination-sorted, padded COO edges of a sparse matrix.

    Padding entries have ``w == 0`` and ``dst == n_rows - 1``, so they add
    nothing wherever they land.
    """

    dst: torch.Tensor  # int32 [nnz_pad], sorted ascending
    src: torch.Tensor  # int32 [nnz_pad]
    w: torch.Tensor    # float32 [nnz_pad]
    n_rows: int
    n_cols: int
    nnz: int           # real (unpadded) count


def edge_list_from_scipy(mat: sp.spmatrix, nnz_pad: Optional[int] = None,
                         pad_multiple: int = 512, *, device=None
                         ) -> EdgeList:
    """Convert a scipy sparse matrix to a padded, dst-sorted EdgeList on
    ``device`` (default cuda, ``resolve_device``): ``nnz_pad`` slots, by
    default the entries rounded up to ``pad_multiple``."""
    device = resolve_device(device)
    csr = mat.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()  # CSR→COO yields row-major (dst-sorted) order
    nnz = coo.nnz
    if nnz_pad is None:
        nnz_pad = _round_up(max(nnz, 1), pad_multiple)
    if nnz_pad < nnz:
        raise ValueError(f"nnz_pad={nnz_pad} < nnz={nnz}")
    n_rows, n_cols = csr.shape
    pad = nnz_pad - nnz
    dst = np.concatenate([coo.row.astype(np.int32),
                          np.full(pad, n_rows - 1, dtype=np.int32)])
    src = np.concatenate([coo.col.astype(np.int32),
                          np.zeros(pad, dtype=np.int32)])
    w = np.concatenate([coo.data.astype(np.float32),
                        np.zeros(pad, dtype=np.float32)])
    return EdgeList(dst=torch.from_numpy(dst).to(device),
                    src=torch.from_numpy(src).to(device),
                    w=torch.from_numpy(w).to(device),
                    n_rows=n_rows, n_cols=n_cols, nnz=nnz)


def rcm_permutation(mat: sp.spmatrix) -> np.ndarray:
    """Bandwidth-reducing reverse Cuthill-McKee row/col permutation."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(mat.tocsr(),
                                            symmetric_mode=True))


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """A sparse matrix in CSR form on one device, the kernels' operand.

    ``perm`` (packed row → original row) and ``iperm`` are set when a
    square matrix was built under a row/col permutation; callers apply
    them once outside their hot loops. ``span`` and ``transposed`` fix
    the canonical id of each stored entry (module docstring).
    ``rows`` (set by ``csr_from_scipy`` and ``csr_transpose``) holds the
    row of each entry; ``fwd_pos``, set by ``csr_transpose``, maps each
    entry of this transpose to its position in the forward matrix. A
    hand-built matrix may leave either None.
    """

    row_ptr: torch.Tensor   # int32 [n_rows + 1]
    col: torch.Tensor       # int32 [nnz], ascending within each row
    val: torch.Tensor       # float32 [nnz]
    n_rows: int
    n_cols: int
    perm: Optional[torch.Tensor] = None   # int32 [n_rows] or None
    iperm: Optional[torch.Tensor] = None  # int32 [n_rows] or None
    span: int = 0             # edge-id span; 0 → max(n_rows, n_cols)
    transposed: bool = False  # entry (r, c) is edge (c, r) of the forward
    fwd_pos: Optional[torch.Tensor] = None  # int32 [nnz] or None
    rows: Optional[torch.Tensor] = None     # int32 [nnz] or None

    @property
    def id_span(self) -> int:
        return self.span or max(self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return self.col.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def row_ids(self) -> torch.Tensor:
        """The row of every stored entry (int64 [nnz]), CSR order."""
        counts = (self.row_ptr[1:] - self.row_ptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.device), counts)

    def to(self, device) -> "CsrMatrix":
        """A copy on ``device`` (the same matrix, ids and permutation)."""
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, row_ptr=move(self.row_ptr), col=move(self.col),
            val=move(self.val), perm=move(self.perm), iperm=move(self.iperm),
            fwd_pos=move(self.fwd_pos), rows=move(self.rows))

    def edge_ids(self) -> torch.Tensor:
        """The canonical id of every stored entry (int64 [nnz], CSR
        order): ``r·span + c``, or ``c·span + r`` for a transpose."""
        r, c = self.row_ids(), self.col.long()
        if self.transposed:
            r, c = c, r
        return r * self.id_span + c


def _rows(indptr: np.ndarray) -> np.ndarray:
    """The row of every entry of a CSR matrix with row pointers
    ``indptr``."""
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))


def csr_transpose(a: CsrMatrix) -> CsrMatrix:
    """The CSR of Aᵀ on A's device: the operator of the backward pass,
    whose entries carry the ids of A's (same ``span``, flipped
    ``transposed``). A permuted square A keeps its ``perm``/``iperm``:
    Aᵀ lives in the same packed coordinates. ``fwd_pos[j]`` is the
    position in A of Aᵀ's entry j, found by transposing the entries'
    positions (int64, exact at any nnz) instead of their values; Aᵀ's
    values are A's gathered through it."""
    if a.nnz >= 2 ** 31:
        raise ValueError(f"nnz={a.nnz} exceeds the int32 index range")
    host = sp.csr_matrix(
        (np.arange(a.nnz, dtype=np.int64), a.col.cpu().numpy(),
         a.row_ptr.cpu().numpy()), shape=(a.n_rows, a.n_cols))
    t = host.T.tocsr()
    t.sort_indices()

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(
            a.device)

    fwd_pos = dev(t.data, np.int32)
    return CsrMatrix(
        row_ptr=dev(t.indptr, np.int32), col=dev(t.indices, np.int32),
        val=a.val.index_select(0, fwd_pos.long()).contiguous(),
        n_rows=a.n_cols, n_cols=a.n_rows, perm=a.perm, iperm=a.iperm,
        span=a.id_span, transposed=not a.transposed, fwd_pos=fwd_pos,
        rows=dev(_rows(t.indptr), np.int32))


def csr_from_scipy(mat: sp.spmatrix, *, device: torch.device,
                   perm: Optional[np.ndarray] = None) -> CsrMatrix:
    """Build a ``CsrMatrix`` on ``device`` from a scipy matrix.

    ``perm`` (square matrices only) relabels rows and columns: packed
    row ``i`` is original row ``perm[i]`` — the JAX packers' convention.
    """
    csr = sp.csr_matrix(mat, dtype=np.float32, copy=True)
    csr.sum_duplicates()
    iperm = None
    if perm is not None:
        perm = np.asarray(perm)
        if csr.shape[0] != csr.shape[1]:
            raise ValueError("perm requires a square matrix")
        if not np.array_equal(np.sort(perm), np.arange(csr.shape[0])):
            raise ValueError("perm is not a permutation of the rows")
        csr = csr[perm][:, perm].tocsr()
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
    csr.sort_indices()
    if csr.nnz >= 2 ** 31:
        raise ValueError(f"nnz={csr.nnz} exceeds the int32 index range")

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    return CsrMatrix(
        row_ptr=dev(csr.indptr, np.int32), col=dev(csr.indices, np.int32),
        val=dev(csr.data, np.float32), n_rows=csr.shape[0],
        n_cols=csr.shape[1],
        perm=None if perm is None else dev(perm, np.int32),
        iperm=None if iperm is None else dev(iperm, np.int32),
        rows=dev(_rows(csr.indptr), np.int32))
