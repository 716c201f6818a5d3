"""The plain reference: APPNP training steps and the eval forward.

Plain PyTorch and NumPy, computed in float64 (``precision="float64"``)
or, for the control, in TF32: every product's operands rounded to TF32's
10-bit mantissa and summed in float32 (``precision="tf32"``), forward and
backward. It imports nothing of ``ppnp_tpu_torch``: from the raw graph
that the benchmark hands it, it works out again everything the program
derives, namely the standardized graph, Â, X's L1 normalization, the
splits, the initial weights, the reverse Cuthill-McKee order, the
blocked plan and the row-sharded plan (``shardplan.py``), and every
dropout mask from the port's key schedule.

The key schedule and the masks are frozen copies of the port's
arithmetic (``ops/hashrng.py``, ``ops/prng.py``, ``ops/dropout.py``,
``kernels/masks.py``, which draw ``jax.random``'s bits): Threefry-2x32
with 20 rounds; ``PRNGKey(s) = (0, s mod 2³²)``; ``split`` and
``fold_in`` as Threefry of counters ``(0, i)``; dense dropout keeps
byte ``j`` of 32-bit word ``w`` of ``bits(key, rows × ceil(last/4))`` as
element ``4w + j`` when it is below ``keep·256``; edge dropout keeps
an edge when the first Threefry word of ``(key; id >> 32, id mod 2³²)``
is below ``keep·2³²``, with the edge's id in the arm's coordinates.

One training step, as ``train.train_model`` runs it (and
``multiseed.train_models`` for each seed): ``key = fold_in(key_epochs,
e)``; ``key_mlp, key_prop = split(key)``; dropout before each of the
two layers, ReLU between them; K steps ``H ← (1-α)·Â_drop·H + α·H⁰``
with the mask of step k from ``split(key_prop, K)[k]`` (in the sharded
arm, of each rank's interior and boundary part from ``fold_in(fold_in(
split(key_prop, K)[k], rank), part)``); NLL on the
training nodes plus ``λ/2·‖W₁‖²``; one Adam step with optax's
arithmetic; then the stopping-set eval: the eval forward (no dropout)
with the updated weights, NLL on the stopping nodes.

**The interface of a reference module.** This module is the default; a
configuration may name another by path (its top-level ``"reference"``,
``spec.Bench.reference``), such as one under ``portbench/references/``.
The harness and ``calibrate.py`` call only these four, with these
arguments, so a module that defines them can stand in:

- ``prepare(adj, attr, labels, *, standardize, arm, x_format,
  rows_per_block, reorder, n_shards, device)``: the problem that the
  other three take, worked out from the raw graph (scipy CSR ``adj`` and
  ``attr``, int ``labels``) on ``device``; ``arm`` is the mix's
  ``edge_ids`` (None where it names none), ``rows_per_block``,
  ``reorder`` and ``n_shards`` the mix's or 0 / None. The problem has
  ``f`` and ``n_classes``.
- ``train_steps(problem, model, split_args, *, seed, split_seed,
  precision, fault)``: the first three training steps of one seed
  (``model`` and ``split_args`` are the configuration's ``model`` and
  ``split`` blocks); a dict of ``losses``, ``stop_losses``, ``grad1``,
  ``params0`` and ``params`` (below). Only training cells call it.
- ``eval_logp(problem, w1, w2, *, alpha, niter, precision="float64",
  fault=None)``: the (n, c) float64 log-probabilities of every node in
  eval mode, under weights in the layout ``x @ w`` (``niter`` is None
  where the model has none). Serving cells call it.
- ``leaf_gaps(program, reference, ref_grads, *, steady_entries=False)``:
  the per-leaf gaps that a training cell's ``grad`` and ``change`` take
  the worst of.

``precision`` is ``"float64"`` or, for the control, ``"tf32"``;
``fault`` names a planted fault (calibrate.py) or None. Such a module
imports nothing of the program; it may import this one, to reuse the
Threefry copies and key schedule, the MLP, Adam and the splits.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from portbench import shardplan

__all__ = ["Problem", "prepare", "train_steps", "eval_logp",
           "glorot_init", "prng_key", "split", "fold_in"]

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_KNOWN_UNKNOWN_SEED = 1707092819
_EDGE_CHUNK = 1 << 22   # entries per gather in the sparse product
_MASK_CHUNK = 1 << 25   # entries (edges, or hidden units) a mask call


# ---------------------------------------------------------------- keys --

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 on numpy uint32 or torch int64 values in [0, 2³²)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _u32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.uint32))


def prng_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & MASK32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    key = _u32(key)
    i = np.arange(num, dtype=np.uint32)
    out0, out1 = threefry2x32(key[0:1], key[1:2], np.zeros_like(i), i)
    return np.stack([out0, out1], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    key = _u32(key)
    out0, out1 = threefry2x32(key[0:1], key[1:2], _u32(0),
                              _u32(int(data) & MASK32))
    return np.concatenate([out0, out1])


def _bits(key, idx: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits`` words at flat indices ``idx`` (int64)."""
    x0, x1 = threefry2x32(int(key[0]), int(key[1]), idx >> 32, idx & MASK32)
    return x0 ^ x1


def _first_word(k0, k1, ids: torch.Tensor) -> torch.Tensor:
    """The first Threefry word at ``ids`` under key words ``(k0, k1)``:
    Python ints, or int64 tensors of one key per id."""
    return threefry2x32(k0, k1, ids >> 32, ids & MASK32)[0]


def glorot_init(key, fan_in: int, fan_out: int, device) -> torch.Tensor:
    """``glorot_uniform()(key, (fan_in, fan_out))`` in float32."""
    b = _bits(key, torch.arange(fan_in * fan_out, device=device))
    one = (b >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats * 2.0 - 1.0, -1.0)
    variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
    scale = float(np.sqrt(np.float32(3) * variance))
    return (u * scale).reshape(fan_in, fan_out)


def _edge_keep(key, ids: torch.Tensor, keep: float) -> torch.Tensor:
    """Edge dropout by id under one key, or under ``key`` (K, 2) indexed
    by ``which`` when ``key`` is a pair (keys, which)."""
    thresh = min(int(keep * 2 ** 32), 2 ** 32 - 1)
    if isinstance(key, tuple):
        keys, which = key
        kt = torch.as_tensor(keys.astype(np.int64), device=ids.device)
        k0, k1 = kt[which, 0], kt[which, 1]
    else:
        k0, k1 = int(key[0]), int(key[1])
    return _first_word(k0, k1, ids) < thresh


def _dense_keep(key, rows: torch.Tensor, cols: torch.Tensor, last: int,
                keep_q: float) -> torch.Tensor:
    """The dense dropout mask of a (·, last) array at (rows, cols)."""
    words = rows * -(-last // 4) + cols // 4
    byte = (_bits(key, words) >> (8 * (cols % 4))) & 0xFF
    return byte < int(keep_q * 256)


def _quantized_keep(drop: float) -> float:
    return round((1.0 - drop) * 256.0) / 256.0


# ----------------------------------------------------------- arithmetic --

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10-bit mantissa, nearest even)."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding of a value forward and of its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


class _SpMM(torch.autograd.Function):
    """``out[r] += val·h[c]`` over the entries (rows, cols, val) of an
    (n_out × h.shape[0]) matrix; differentiable in ``h`` only."""

    @staticmethod
    def forward(ctx, h, rows, cols, val, n_out):
        ctx.save_for_backward(rows, cols, val)
        ctx.n_in = h.shape[0]
        return _spmm(rows, cols, val, h, n_out)

    @staticmethod
    def backward(ctx, g):
        rows, cols, val = ctx.saved_tensors
        return _spmm(cols, rows, val, g, ctx.n_in), None, None, None, None


class _Csr(NamedTuple):
    """The entries (rows, cols) of an (n_rows × n_cols) matrix in CSR
    order, and its transpose's: the transpose's k-th entry is entry
    ``order_t[k]``."""
    crow: torch.Tensor
    col: torch.Tensor
    crow_t: torch.Tensor
    col_t: torch.Tensor
    order_t: torch.Tensor
    n_rows: int
    n_cols: int


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
         n_cols: int) -> _Csr:
    """``_Csr`` of entries already in CSR order (rows, then columns)."""
    def crow(r, n):
        out = torch.zeros(n + 1, dtype=torch.int64, device=r.device)
        out[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
        return out
    order_t = torch.argsort(cols * n_rows + rows)
    return _Csr(crow(rows, n_rows), cols, crow(cols, n_cols),
                rows[order_t], order_t, n_rows, n_cols)


class _CsrSpMM(torch.autograd.Function):
    """``_SpMM`` as a sparse CSR product, for the large problems: no
    scattered adds. Differentiable in ``h`` only."""

    @staticmethod
    def forward(ctx, h, val, csr: _Csr):
        ctx.save_for_backward(val)
        ctx.csr = csr
        return _sparse(csr.crow, csr.col, val, (csr.n_rows, csr.n_cols)) @ h

    @staticmethod
    def backward(ctx, g):
        (val,), csr = ctx.saved_tensors, ctx.csr
        a_t = _sparse(csr.crow_t, csr.col_t, val[csr.order_t],
                      (csr.n_cols, csr.n_rows))
        return a_t @ g.contiguous(), None, None


def _sparse(crow, col, val, size) -> torch.Tensor:
    with warnings.catch_warnings():  # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col, val, size,
                                       check_invariants=False)


def _spmm(rows, cols, val, h, n_out):
    out = h.new_zeros((n_out, h.shape[1]))
    for lo in range(0, rows.shape[0], _EDGE_CHUNK):
        sl = slice(lo, lo + _EDGE_CHUNK)
        out.index_add_(0, rows[sl], h.index_select(0, cols[sl])
                       * val[sl, None])
    return out


@dataclasses.dataclass
class _Math:
    """float64, or TF32 operands summed in float32."""
    precision: str

    @property
    def dtype(self):
        return torch.float64 if self.precision == "float64" else torch.float32

    def r(self, x):
        x = x.to(self.dtype)
        return x if self.precision == "float64" else _Round.apply(x)

    def mm(self, a, b):
        return self.r(self.r(a) @ self.r(b))

    def spmm(self, rows, cols, val, h, n_out, csr: Optional[_Csr] = None):
        if csr is not None:
            return self.r(_CsrSpMM.apply(self.r(h), self.r(val), csr))
        return self.r(_SpMM.apply(self.r(h), rows, cols, self.r(val), n_out))


# ------------------------------------------------------------- problem --

@dataclasses.dataclass
class Problem:
    """What the reference works out from the raw graph, on ``device``:
    Â's entries in original coordinates with each entry's id and block
    in the arm's plan, X's entries (L1-normalized), the labels."""
    n: int
    f: int
    n_classes: int
    labels: np.ndarray
    a_rows: torch.Tensor
    a_cols: torch.Tensor
    a_val: torch.Tensor        # float64
    a_ids: Optional[torch.Tensor]
    a_block: Optional[torch.Tensor]
    x_rows: torch.Tensor
    x_cols: torch.Tensor
    x_val: torch.Tensor        # float64
    x_ids: torch.Tensor        # id-keyed masks of a sparse X
    x_format: str
    device: torch.device
    n_shards: int = 0          # the sharded arm's ranks (a_block: 2·rank
    #                            + part)
    a_csr: Optional[_Csr] = None  # the sharded arm: Â and X as CSR
    x_csr: Optional[_Csr] = None  # products, entries in CSR order


def _standardize(adj, attr, labels):
    adj = sp.csr_matrix(adj, dtype=np.float64, copy=True)
    adj.data[:] = 1.0
    adj = adj.maximum(adj.T).tocsr()
    adj.data[:] = 1.0
    adj = adj.tolil()
    adj.setdiag(0)
    adj = adj.tocsr()
    adj.eliminate_zeros()
    _, comp = sp.csgraph.connected_components(adj)
    sizes = np.bincount(comp)
    keep = np.where(comp == np.argmax(sizes))[0]
    keep = np.sort(keep)
    return adj[keep][:, keep], attr[keep], labels[keep]


def _a_hat(adj) -> sp.csr_matrix:
    a = sp.csr_matrix(adj, dtype=np.float64) + sp.eye(adj.shape[0],
                                                       format="csr")
    d = 1.0 / np.sqrt(np.asarray(a.sum(axis=1)).ravel())
    return (sp.diags(d) @ a @ sp.diags(d)).tocsr()


def _rcm(a: sp.csr_matrix) -> np.ndarray:
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(a.tocsr(), symmetric_mode=True))


def _blocked_plan(pr, pc, n, r):
    """Each entry's block and id in the blocked plan (row blocks of r
    rows; one 8-aligned window of H per block, clamped to end in the
    padded rows; ids over span max(r, hw) within a block)."""
    n_blocks = max(1, -(-n // r))
    n_pad = r * n_blocks
    blk = pr // r
    lo = np.zeros(n_blocks, np.int64)
    span = np.full(n_blocks, 8, np.int64)
    cmin = np.full(n_blocks, np.iinfo(np.int64).max)
    cmax = np.full(n_blocks, -1, np.int64)
    np.minimum.at(cmin, blk, pc)
    np.maximum.at(cmax, blk, pc)
    has = cmax >= 0
    lo[has] = cmin[has] >> 3 << 3
    span[has] = cmax[has] + 1 - lo[has]
    hw = min(-(-int(span.max()) // 8) * 8, n_pad)
    col_lo = np.minimum(lo, n_pad - hw)
    ids = (pr - blk * r) * max(r, hw) + (pc - col_lo[blk])
    return blk, ids


def prepare(adj, attr, labels, *, standardize: bool, arm: str,
            x_format: str, rows_per_block: int = 0,
            reorder: Optional[str] = None, n_shards: int = 0,
            device="cpu") -> Problem:
    """The reference's own derivation of every input of a run.

    ``arm`` fixes the coordinates of the edge ids: ``"rcm"`` (the CSR
    arms, under the reverse Cuthill-McKee order), ``"blocked"`` (row
    blocks of ``rows_per_block``, after ``reorder``) or ``"sharded"``
    (the pallas arm's interior and boundary parts of ``n_shards`` ranks,
    in the graph's own node order). The xla arm keys its masks by
    edge-list slot instead, which this reference does not derive."""
    if arm not in ("rcm", "blocked", "sharded"):
        raise ValueError(f"edge ids in coordinates {arm!r}: the reference "
                         "derives 'rcm' (pallas, fused), 'blocked' and "
                         "'sharded'")
    if arm == "sharded" and (reorder is not None or n_shards < 1):
        raise ValueError("the sharded arm's ids are derived in the graph's "
                         "own order (reorder None), over n_shards >= 1")
    device = torch.device(device)
    labels = np.asarray(labels)
    if standardize:
        adj, attr, labels = _standardize(adj, attr, labels)
    if arm == "sharded":
        return _prepare_sharded(adj, attr, labels, x_format, n_shards,
                                device)
    a_hat = _a_hat(adj)
    a = a_hat.tocoo()
    rows, cols = a.row.astype(np.int64), a.col.astype(np.int64)
    n = a.shape[0]
    ids = blk = None
    if arm == "rcm" or (arm == "blocked" and reorder == "rcm"):
        perm = _rcm(a_hat)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n)
        pr, pc = iperm[rows], iperm[cols]
    else:
        pr, pc = rows, cols
    if arm == "rcm":
        ids = pr * n + pc
    elif arm == "blocked":
        blk, ids = _blocked_plan(pr, pc, n, rows_per_block)

    x = sp.csr_matrix(attr, dtype=np.float64)
    sums = np.asarray(x.sum(axis=1)).ravel()
    x = (sp.diags(np.where(sums > 0, 1.0 / np.maximum(sums, 1e-12), 0.0))
         @ x).tocoo()
    xr, xc = x.row.astype(np.int64), x.col.astype(np.int64)

    def dev(v, dtype=torch.int64):
        return None if v is None else torch.as_tensor(
            np.ascontiguousarray(v)).to(device=device, dtype=dtype)

    return Problem(
        n=n, f=x.shape[1], n_classes=int(labels.max()) + 1, labels=labels,
        a_rows=dev(rows), a_cols=dev(cols), a_val=dev(a.data, torch.float64),
        a_ids=dev(ids), a_block=dev(blk), x_rows=dev(xr), x_cols=dev(xc),
        x_val=dev(x.data, torch.float64),
        x_ids=dev(xr * max(n, x.shape[1]) + xc), x_format=x_format,
        device=device)


def _prepare_sharded(adj, attr, labels, x_format: str, n_shards: int,
                     device) -> Problem:
    """``prepare`` for the sharded arm, whose graphs are large: Â's
    entries worked out on ``device`` in CSR order (A + I with each
    entry ``a_rc / sqrt(d_r·d_c)``, d the rows' sums, as ``_a_hat``),
    each entry's rank, part and id (``shardplan``), and X's entries;
    products go through ``_Csr``."""
    a = sp.csr_matrix(adj)
    a.sum_duplicates()
    n = a.shape[0]
    counts = torch.from_numpy(np.diff(a.indptr).astype(np.int64)).to(device)
    rows = torch.repeat_interleave(torch.arange(n, device=device), counts)
    cols = torch.from_numpy(a.indices).to(device).long()
    vals = torch.from_numpy(a.data).to(device, torch.float64)
    diag = torch.arange(n, device=device)
    order = torch.argsort(torch.cat([rows, diag]) * n + torch.cat([cols, diag]))
    rows = torch.cat([rows, diag])[order]
    cols = torch.cat([cols, diag])[order]
    vals = torch.cat([vals, torch.ones(n, dtype=torch.float64,
                                       device=device)])[order]
    del order
    deg = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, rows, vals)
    d = 1.0 / torch.sqrt(deg)
    a_val = d[rows] * vals * d[cols]
    plan = shardplan.plan(rows, cols, n, n_shards)

    x = sp.csr_matrix(attr, dtype=np.float64)
    x.sum_duplicates()
    sums = np.asarray(x.sum(axis=1)).ravel()
    x = (sp.diags(np.where(sums > 0, 1.0 / np.maximum(sums, 1e-12), 0.0))
         @ x).tocsr()
    x.sort_indices()
    xr = torch.repeat_interleave(
        torch.arange(n, device=device),
        torch.from_numpy(np.diff(x.indptr).astype(np.int64)).to(device))
    xc = torch.from_numpy(x.indices).to(device).long()
    return Problem(
        n=n, f=x.shape[1], n_classes=int(labels.max()) + 1, labels=labels,
        a_rows=rows, a_cols=cols, a_val=a_val, a_ids=plan.ids,
        a_block=2 * plan.rank + plan.part, x_rows=xr, x_cols=xc,
        x_val=torch.from_numpy(x.data).to(device),
        x_ids=xr * max(n, x.shape[1]) + xc, x_format=x_format,
        device=device, n_shards=n_shards,
        a_csr=_csr(rows, cols, n, n), x_csr=_csr(xr, xc, n, x.shape[1]))


def gen_splits(labels: np.ndarray, split: Dict[str, int], seed: int):
    """(train, stopping) node indices of the protocol: a fixed known
    pool of ``nknown`` nodes, then per class ``ntrain_per_class`` train
    nodes and ``nstopping`` stopping nodes, drawn with ``seed``."""
    idx = np.arange(len(labels))
    known = np.random.RandomState(_KNOWN_UNKNOWN_SEED).choice(
        idx, min(split["nknown"], len(labels)), replace=False)
    rnd = np.random.RandomState(seed)
    known_labels = labels[known]
    train = np.concatenate([
        rnd.choice(known[known_labels == c],
                   min(split["ntrain_per_class"],
                       int((known_labels == c).sum())), replace=False)
        for c in range(int(labels.max()) + 1)])
    stopping = rnd.choice(known[~np.isin(known, train)], split["nstopping"],
                          replace=False)
    return train, stopping


# ------------------------------------------------------------- forward --

def _part_keys(key, n_shards: int, fault: Optional[str]) -> np.ndarray:
    """The sharded arm's keys of one step, row ``2·rank + part``:
    ``fold_in(fold_in(key, rank), part)``. The fault ``"rank0_key"``
    masks rank 1's interior with rank 0's key."""
    keys = np.stack([fold_in(fold_in(key, d), q) for d in range(n_shards)
                     for q in (0, 1)])
    if fault == "rank0_key" and n_shards > 1:
        keys[2] = keys[0]
    return keys


def _sharded_keep(keys: np.ndarray, which: torch.Tensor, ids: torch.Tensor,
                  keep: float) -> torch.Tensor:
    """``_edge_keep`` under one key of ``keys`` an entry, in chunks."""
    return torch.cat([_edge_keep((keys, which[lo:lo + _MASK_CHUNK]),
                                 ids[lo:lo + _MASK_CHUNK], keep)
                      for lo in range(0, ids.shape[0], _MASK_CHUNK)])


def _propagate(p: Problem, m: _Math, h0, alpha, niter, key_prop,
               drop: float, fault: Optional[str] = None):
    """K power-iteration steps; with ``key_prop`` each step's edges are
    dropped by id (block b of a blocked plan keyed by ``fold_in``; the
    sharded arm by ``_part_keys``). The fault ``"no_exchange"`` leaves
    out the sharded arm's boundary entries, the rows an exchange
    brings."""
    keys = split(key_prop, niter) if key_prop is not None else None
    keep = 1.0 - drop
    val = (1.0 - alpha) * p.a_val
    cut = (p.a_block % 2 == 1 if fault == "no_exchange" and p.n_shards
           else None)
    h = h0
    for k in range(niter):
        w = val
        if keys is not None:
            if p.n_shards:
                kept = _sharded_keep(_part_keys(keys[k], p.n_shards, fault),
                                     p.a_block, p.a_ids, keep)
            elif p.a_block is None:
                kept = _edge_keep(keys[k], p.a_ids, keep)
            else:
                n_blocks = int(p.a_block.max()) + 1
                block_keys = np.stack([fold_in(keys[k], b)
                                       for b in range(n_blocks)])
                kept = _edge_keep((block_keys, p.a_block), p.a_ids, keep)
            w = torch.where(kept, (1.0 - alpha) * (p.a_val / keep),
                            torch.zeros_like(val))
        if cut is not None:
            w = torch.where(cut, torch.zeros_like(w), w)
        h = m.spmm(p.a_rows, p.a_cols, w, h, p.n, p.a_csr) + m.r(alpha * h0)
    return h


def _hidden_keep(key, n: int, hid: int, keep_q: float,
                 device) -> torch.Tensor:
    """The (n, hid) dense dropout mask of the hidden layer, in blocks of
    rows where it is large."""
    block = max(1, _MASK_CHUNK // hid) if n * hid > _MASK_CHUNK else n
    out = []
    for lo in range(0, n, block):
        rows = min(block, n - lo)
        r = torch.arange(lo, lo + rows, device=device)[:, None].expand(
            rows, hid)
        c = torch.arange(hid, device=device)[None, :].expand(rows, hid)
        out.append(_dense_keep(key, r.reshape(-1), c.reshape(-1), hid,
                               keep_q).reshape(rows, hid))
    return out[0] if len(out) == 1 else torch.cat(out)


def _local_logits(p: Problem, m: _Math, w1, w2, key_mlp, drop: float):
    x_val = p.x_val
    h_keep = None
    if key_mlp is not None:
        k1, k2 = split(key_mlp, 2)
        if p.x_format == "sparse":
            kept = _edge_keep(k1, p.x_ids, 1.0 - drop)
            x_val = torch.where(kept, x_val / (1.0 - drop),
                                torch.zeros_like(x_val))
        else:
            keep_q = _quantized_keep(drop)
            kept = _dense_keep(k1, p.x_rows, p.x_cols, p.f, keep_q)
            x_val = torch.where(kept, x_val / keep_q, torch.zeros_like(x_val))
        hid = w1.shape[1]
        keep_q = _quantized_keep(drop)
        h_keep = (_hidden_keep(k2, p.n, hid, keep_q, p.device), keep_q)
    h = F.relu(m.spmm(p.x_rows, p.x_cols, x_val, w1, p.n, p.x_csr))
    if h_keep is not None:
        mask, keep_q = h_keep
        h = torch.where(mask, h / keep_q, torch.zeros_like(h))
    return m.mm(h, w2)


def eval_logp(p: Problem, w1, w2, *, alpha: float, niter: int,
              precision: str = "float64",
              fault: Optional[str] = None) -> torch.Tensor:
    """Log-probabilities of every node, eval mode (no dropout)."""
    m = _Math(precision)
    with torch.no_grad():
        h0 = _local_logits(p, m, m.r(w1.to(p.device)), m.r(w2.to(p.device)),
                           None, 0.0)
        return F.log_softmax(_propagate(p, m, h0, alpha, niter, None, 0.0,
                                        fault), dim=-1).to(torch.float64)


def train_steps(p: Problem, model: Dict, split_args: Dict[str, int], *,
                seed: int, split_seed: int, n_steps: int = 3,
                precision: str = "float64", fault: Optional[str] = None
                ) -> Dict[str, List]:
    """The first ``n_steps`` training steps of one seed.

    Returns ``losses`` (one per step, before its update),
    ``stop_losses`` (the stopping set's after each update), ``grad1``
    (the first step's gradient per weight), ``params0`` and ``params``
    (the weights before the first step and after the last). ``fault`` plants
    one for the limits' upper readings: ``"half_batch"`` takes the mean
    over half of the training nodes; in the sharded arm ``"rank0_key"``
    and ``"no_exchange"`` (``_propagate``)."""
    m = _Math(precision)
    hidden = list(model["hidden"])
    alpha, niter = float(model["alpha"]), int(model["niter"])
    drop, lam, lr = (float(model["drop_prob"]), float(model["reg_lambda"]),
                     float(model["learning_rate"]))
    train, stopping = gen_splits(p.labels, split_args, split_seed)
    sidx = torch.as_tensor(stopping, device=p.device)
    y_stop = torch.as_tensor(p.labels[stopping].astype(np.int64),
                             device=p.device)
    if fault == "half_batch":
        train = train[: len(train) // 2]
    idx = torch.as_tensor(train, device=p.device)
    y = torch.as_tensor(p.labels[train].astype(np.int64), device=p.device)
    key_init, key_epochs = split(prng_key(seed))
    dims = [p.f, *hidden, p.n_classes]
    init_keys = split(key_init, len(dims) - 1)
    params = [glorot_init(k, a, b, p.device).to(m.dtype).requires_grad_()
              for k, a, b in zip(init_keys, dims[:-1], dims[1:])]
    if len(params) != 2:
        raise ValueError("the reference runs the two-layer MLP")
    params0 = [q.detach().clone() for q in params]
    mu = [torch.zeros_like(q) for q in params]
    nu = [torch.zeros_like(q) for q in params]
    losses, stop_losses, grad1 = [], [], None
    for e in range(n_steps):
        key_mlp, key_prop = split(fold_in(key_epochs, e))
        h0 = _local_logits(p, m, params[0], params[1], key_mlp, drop)
        z = _propagate(p, m, h0, alpha, niter, key_prop, drop, fault)
        logp = F.log_softmax(z.index_select(0, idx), dim=-1)
        nll = -logp.gather(1, y[:, None]).sum() / len(train)
        loss = nll + (lam / 2.0) * torch.sum(params[0] ** 2)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if e == 0:
            grad1 = [g.detach().clone() for g in grads]
        with torch.no_grad():
            c1, c2 = _bias_correction(0.9, e + 1), _bias_correction(0.999,
                                                                  e + 1)
            for q, g, mu_q, nu_q in zip(params, grads, mu, nu):
                mu_q.mul_(0.9).add_(0.1 * g)
                nu_q.mul_(0.999).add_(0.001 * g * g)
                q.add_(-lr * (mu_q / c1) / (torch.sqrt(nu_q / c2) + 1e-8))
        logp = eval_logp(p, params[0].detach(), params[1].detach(),
                         alpha=alpha, niter=niter, precision=precision,
                         fault=fault)
        stop_losses.append(float(-logp[sidx].gather(
            1, y_stop[:, None]).mean()))
    return {"losses": losses, "stop_losses": stop_losses, "grad1": grad1,
            "params0": params0, "params": [q.detach() for q in params]}


def _bias_correction(b: float, t: int) -> float:
    """Adam's ``1 - b^t`` as optax computes it for float32 weights, with
    ``b`` a float32: ``1 - float32(0.999)`` is 1.3e-5 away from 0.001,
    which would otherwise read as a gap in every step's change."""
    return float(np.float32(1) - np.float32(b) ** np.float32(t))


def leaf_gaps(program: Sequence[torch.Tensor],
              reference: Sequence[torch.Tensor],
              ref_grads: Sequence[torch.Tensor], *,
              steady_entries: bool = False) -> List[float]:
    """Per leaf, ``|‖program‖ − ‖reference‖|`` over the larger of the
    reference leaf's norm and the median leaf's. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out:
    rounding alone moves them. With ``steady_entries`` the norms also
    leave out each leaf's entries whose reference gradient is under a
    thousandth of the leaf's median entry's: Adam steps such a weight by
    ``g / (|g| + eps)``, which f32 rounding of a near-zero ``g`` moves by
    up to its whole size."""
    ref_n = np.array([float(torch.linalg.vector_norm(r.double()))
                      for r in reference])
    grad_n = np.array([float(torch.linalg.vector_norm(g.double()))
                       for g in ref_grads])
    med, gmed = float(np.median(ref_n)), float(np.median(grad_n))
    out = []
    for prog, ref, g, rn, gn in zip(program, reference, ref_grads, ref_n,
                                    grad_n):
        if gn < 1e-3 * gmed:
            continue
        pn = float(torch.linalg.vector_norm(prog.double()))
        if steady_entries:
            g = g.abs().to(prog.device)
            keep = g >= 1e-3 * g.median()
            pn = float(torch.linalg.vector_norm(prog.double()[keep]))
            rn = float(torch.linalg.vector_norm(
                ref.double().to(prog.device)[keep]))
        out.append(abs(pn - rn) / max(rn, med))
    return out
