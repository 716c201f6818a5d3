#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ppnp_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, in
order; any failure exits non-zero and nothing is caught:

1. print the card's name and power limit (nvidia-smi); require CUDA and
   full-f32 matmuls (``allow_tf32`` False);
2. build every kernel from ``ppnp_tpu_torch/csrc`` (one nvcc per source,
   started together) and print the build seconds;
3. hold each kernel and mode against its plain PyTorch version on the
   card at the MS Academic shapes of the main path, within
   rtol = atol = 1e-5 (only the f32 summation order differs): K1 forward
   (propagation step, sparse fc1), K1 backward (Âᵀ, c = 15; Xᵀ·dH,
   c = 64), K3 forward and adjoint (K reversed masked planes); the mask
   kernels bit-equal to their plain int64 Threefry run on the CPU at
   every shape the main path draws (edge masks of Â + Âᵀ at K and G·K
   planes and of X + Xᵀ at 1 and G; dense masks of n × 64 for 1 and G
   keys, beside G single-key launches, and the xla step masks for K and
   G·K keys), after checking Âᵀ's position map (val_t == val[fwd_pos],
   ids too); the integer instructions of one Threefry draw, counted by
   pipe in the SASS of a compiled probe, held to the counts the masks'
   bounds use. Time kernel, plain version and the nearest single PyTorch
   call (CUDA events); every kernel also gives the same bits when
   launched twice on the same inputs.
   K3 is also held bit for bit against K queued K1 launches (forward,
   shared plane and K planes) and K queued K1-backward launches
   accumulated in PyTorch (adjoint), and timed beside K = 1, those
   chains, and operators of the same n with no edges, one edge to itself
   and one edge to a random row a row; its launch report prints blocks,
   rows per band, the bands a block waits on and where its clock went.
   K2 (grouped, G = 10 seeds) is held the same way at the propagation
   step (150 lanes, with init) and its backward on Âᵀ, and at the sparse
   fc1 (640 lanes) and its backward on Xᵀ, and bit for bit against G K1
   launches on the per-group slices; K1 also at the batched sweep's eval
   shapes (the step at G·c = 150 lanes with init and one shared plane,
   fc1 at G·hidden = 640 lanes); and at the retrieval width c = 64 on
   Â: K3 (shared plane) held bit-equal to K queued K1 launches before it
   is timed, and the K1 step, each beside its plain version (K1 also
   beside ``torch.addmm``);
4. serving: write a checkpoint of random weights from a seeded
   generator, then run ``python -m ppnp_tpu_torch predict`` in process
   through the xla, pallas and fused backends, several requests each;
   assert the kernels' launch counts and that the backends agree (the
   fused and pallas arms' log-probs bit for bit);
5. training: run ``python -m ppnp_tpu_torch train`` in process on
   ms_academic with sparse X, ~20 epochs on the pallas and fused arms and
   a few on the xla arm; assert the launch counts per epoch, a finite
   and falling loss, one epoch on the card against the same epoch on the
   CPU, and that ``predict`` serves each trained checkpoint on every arm
   with the same argmax; print ms per epoch per arm;
6. seed sweep: run ``python -m ppnp_tpu_torch reproduce`` in process on
   ms_academic, sparse X, the 10 default seeds in one batch (~20 epochs
   pallas, a few xla), and 2 seeds serially; assert launch counts per
   batched epoch, finite and falling per-seed losses, and batched losses
   equal to the serial ones within 1e-5; print ms per batched epoch
   beside G × the serial epoch, and profile batched epochs;
7. exact PPNP: ``reproduce --propagation exact`` on Citeseer (2 seeds),
   then ``calc_ppr_exact`` at the PubMed surrogate's n, timed, with its
   residual checked;
8. retrieval: the hidden table of the pallas-trained checkpoint on the
   fused, pallas and xla arms (one K3 launch; K K1 launches), fused
   bit-equal to pallas, xla within 1e-4 of a float64 forward;
   ``retrieve_topk`` on 1,024 noisy queries against a float64 oracle;
   ``python -m ppnp_tpu_torch retrieve`` once on the fused arm, its
   launch counts asserted;
9. benches: every ported bench of ``ppnp_tpu_torch.benchmarks`` once at
   small iteration counts (propagation on the three arms at c = 128,
   K = 100; the c-sweep; serving and retrieval; training and its
   breakdown on pallas and fused; exact PPNP on PubMed; host ingest),
   each result printed as a JSON line; fails on an ``"error"`` entry or
   a wrong result;
10. print one ``{"kernels": [...]}`` line (launches per path, the
   ``retrieve <arm>`` and ``bench <name>`` paths included), then the
   card line, then ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout (the package is imported from the checkout). With
``--kernels-only`` it runs phases 1–3 alone and prints their records
instead of a result: run it in two checkouts, in turns, to compare their
kernels on one card.
"""

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DATASET = "ms_academic"
REQUESTS = 3           # forward passes per backend in the serving phase
EPOCHS = {"pallas": 20, "fused": 20, "xla": 4}   # training phase
SWEEP_EPOCHS = {"pallas": 20, "xla": 4}   # batched seed sweep, G = 10
SERIAL_SEEDS, SERIAL_EPOCHS = 2, 4        # serial sweep beside it
SWEEP_TOL = 1e-5       # batched vs serial per-seed losses: f32 sum order
EXACT_EPOCHS = 10      # exact Citeseer sweep
HIDDEN = 64            # the hidden width: the retrieval table's columns
RETRIEVE_EPOCHS = 10   # the retrieve CLI's training run
QUERIES = 1024         # noisy table rows scored in the retrieval phase
EXACT_RESID = 1e-4     # max |M Π - α I| of the f32 solve at n = 19,717
RTOL = ATOL = 1e-5     # kernel vs plain version: f32 summation order only
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # one epoch, card vs CPU: weight grads
AGREE = 0.999          # pallas / fused argmax equal to xla on ≥ this share
REF_TOL = 1e-4         # xla arm (f32) vs the float64 reference forward
# 32-bit integer instructions of one Threefry-2x32 draw in the SASS nvcc
# builds for sm_90a, by pipe: (INT32 lanes: IADD3, LOP3, SHF; FMA pipe:
# IMAD, which nvcc also uses for adds), using both words (dense masks) and
# the first word alone (edge masks); ``sass_int_ops`` holds the build to
# them
DRAW_BOTH, DRAW_FIRST = (50, 17), (47, 16)
SLEEP_CYCLES = 20_000_000   # ~10 ms of GPU clock: covers enqueueing 20 calls
SLOW_MS = 100.0        # calls slower than this are timed alone (time_ms)
EXTRA_INNER = 5   # calls per timing of a record's extras (chains of launches)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
# 32-bit integer add, logic and shift: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (the SXM part's boost clock), one operation a lane a clock
INT32_OPS = 16.7e12
# instruction issue: one warp instruction a sub-partition a clock, 132 x 4
# x 32 x 1.98 GHz thread-instructions; IMAD runs on the FMA pipe (at most
# the SM's 128 FP32 lanes, no faster than this), so the integer
# instructions of both pipes together over this rate also bound
ISSUE_OPS = 33.4e12
ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, inner: int = 20, reps: int = 11, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``inner``
    calls queued behind a sleep kernel, so that the host has enqueued
    them before the first one starts and its launch overhead is hidden;
    median over ``reps``. A call that waits for the host (the plain
    versions do) is timed with that wait. A call slower than SLOW_MS
    (the plain versions at the largest mask shapes) is timed alone, 3
    times: queueing hides nothing there, and 11 x 20 of it would keep the
    card busy for minutes and heat it before the next kernel is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if call_ms(fn, reps=1, warmup=0) > SLOW_MS:
        inner, reps = 1, 3
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def call_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one ``fn()`` call issued to an idle card, CUDA
    events: the device waits for the host, so this includes the
    wrapper's own host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, flops: float, int_ops=(0, 0)):
    """(least ms on the card, what bounds it): the largest of the bytes at
    the HBM rate, the f32 operations at their peak, and the 32-bit integer
    instructions ``int_ops`` = (on the INT32 lanes, IMAD on the FMA pipe):
    those of the INT32 lanes at their rate, and both together at the issue
    rate."""
    lanes, imad = int_ops
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS, lanes / INT32_OPS,
                (lanes + imad) / ISSUE_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def draw_ops(draws: int, draw) -> tuple:
    """The integer instructions of ``draws`` Threefry draws, by pipe."""
    return draws * draw[0], draws * draw[1]


def compare(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise SystemExit(f"{name}: shape {tuple(out.shape)} vs "
                         f"{tuple(ref.shape)} or non-finite output")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    return err


def band_distinct(m, band: int) -> float:
    """Distinct columns over edges, counted per band of ``band``
    consecutive rows of the CSR operator ``m`` (on the host)."""
    rp, col = m.row_ptr.cpu(), m.col.cpu()
    return sum(torch.unique(col[rp[s]:rp[min(s + band, m.n_rows)]]).numel()
               for s in range(0, m.n_rows, band)) / m.nnz


def csr_tensor(a, values):
    return torch.sparse_csr_tensor(a.row_ptr, a.col, values,
                                   size=(a.n_rows, a.n_cols))


def record(name, kernel, plain, library, bytes_moved, flops,
           exact_ref=None, int_ops=(0, 0), **extra_ms):
    """Compare (bit-equal to ``exact_ref`` where one is given, else within
    the tolerance of the plain version), check that a second launch gives
    the same bits, and time kernel, plain version, library call and each
    of ``extra_ms`` (name: function). ``flops`` and ``int_ops`` are the
    f32 operations and 32-bit integer instructions of the bound."""
    out = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(o, a) for o, a in
               zip(*((out, again) if isinstance(out, tuple)
                     else ((out,), (again,))))):
        raise SystemExit(f"{name}: two launches on the same inputs differ")
    if exact_ref is not None:
        torch.cuda.synchronize()
        for o, r in zip(out, exact_ref):
            if not torch.equal(o.cpu(), r):
                raise SystemExit(f"{name}: not bit-equal to the plain "
                                 "version run on the CPU")
        err = 0.0
    else:
        err = compare(name, out, plain())
    b_ms, b_by = bound(bytes_moved, flops, int_ops)
    rec = dict(max_abs_err=err, ms=time_ms(kernel),
               plain_ms=time_ms(plain),
               library_ms=None if library is None else time_ms(library),
               bound_ms=b_ms, bound_by=b_by, call_ms=call_ms(kernel),
               **{k: time_ms(fn, inner=EXTRA_INNER)
                  for k, fn in extra_ms.items()})
    print(f"{name}: max_abs_err={err:.3g} "
          f"({'bit-equal' if exact_ref is not None else f'tol rtol=atol={RTOL}'}"
          "; two launches bit-equal) "
          + " ".join(f"{k}={v}" for k, v in rec.items()
                     if k != "max_abs_err"))
    return rec


def kernel_phases(dev):
    """Phase 3: each kernel and mode against its plain version at
    main-path shapes. Returns the per-kernel records (without launches)
    and the names of the K3 checks that were not bit-equal to their K1
    chains."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.fused import appnp_fused, appnp_fused_plain
    from ppnp_tpu_torch.kernels.masks import edge_masks
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_bwd,
                                             spmm_csr_plain)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.sparse import CsrMatrix
    from ppnp_tpu_torch.train import prepare_attr_input

    cfg = RunConfig(dataset=DATASET, backend="pallas")
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    a, a_t, alpha, niter = prop.csr, prop.csr_t, prop.alpha, prop.niter
    xin = prepare_attr_input(graph, prop, x_format="sparse")
    x, x_t = xin.csr, xin.csr_t
    n = a.n_rows
    c = int(graph.labels.max()) + 1
    f, hidden = x.n_cols, 64
    rng = np.random.RandomState(0)
    h = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dev)
    init = alpha * h
    w_fc1 = torch.from_numpy(
        (0.03 * rng.randn(f, hidden)).astype(np.float32)).to(dev)
    dh = torch.from_numpy(rng.randn(n, hidden).astype(np.float32)).to(dev)
    ws, ws_t = prop.w_scaled, prop.w_t_scaled
    print(f"shapes: n={n} nnz(A)={a.nnz} c={c} | X {n}x{f} "
          f"nnz(X)={x.nnz} hidden={hidden} | alpha={alpha} K={niter}")
    ops = (("A", a), ("A^T", a_t), ("X", x), ("X^T", x_t))
    print("entries per row (mean, max): " + ", ".join(
        f"{name} {m.nnz / m.n_rows:.2f}, {int(torch.diff(m.row_ptr).max())}"
        for name, m in ops))
    print("distinct rows of H gathered per 512-row band, over edges (the "
          "most L1 could serve is 1 minus this): " + ", ".join(
              f"{name} {band_distinct(m, 512):.3f}" for name, m in ops))

    recs = {}
    # K1 at the propagation step: (1-α)Â @ H + α·H⁰
    a_lib = csr_tensor(a, ws)
    step = record("K1 step", lambda: spmm_csr(a, h, ws, init),
                  lambda: spmm_csr_plain(a, h, ws, init),
                  lambda: torch.addmm(init, a_lib, h),
                  (n + 1) * 4 + a.nnz * 8 + 3 * n * c * 4,
                  2 * a.nnz * c + n * c)
    # K1 as the sparse fc1: X @ W₁
    x_lib = csr_tensor(x, x.val)
    fc1 = record("K1 fc1", lambda: spmm_csr(x, w_fc1),
                 lambda: spmm_csr_plain(x, w_fc1),
                 lambda: torch.sparse.mm(x_lib, w_fc1),
                 (n + 1) * 4 + x.nnz * 8 + f * hidden * 4 + n * hidden * 4,
                 2 * x.nnz * hidden)
    # one record per kernel: K1's headline numbers are at the propagation
    # step (10 of its 11 launches per pallas request); fc1 rides along
    recs["spmm_csr"] = dict(step, max_abs_err=max(step["max_abs_err"],
                                                  fc1["max_abs_err"]),
                            fc1=fc1)
    # K1 backward: (1-α)Âᵀ_drop @ g on the CSR of Âᵀ, and dW = Xᵀ @ dH
    at_lib = csr_tensor(a_t, ws_t)
    bwd = record("K1 bwd step", lambda: spmm_csr_bwd(a_t, g, ws_t),
                 lambda: spmm_csr_plain(a_t, g, ws_t),
                 lambda: torch.sparse.mm(at_lib, g),
                 (n + 1) * 4 + a_t.nnz * 8 + 2 * n * c * 4,
                 2 * a_t.nnz * c)
    xt_lib = csr_tensor(x_t, x_t.val)
    bwd_x = record("K1 bwd fc1 (dW)", lambda: spmm_csr_bwd(x_t, dh, x_t.val),
                   lambda: spmm_csr_plain(x_t, dh, x_t.val),
                   lambda: torch.sparse.mm(xt_lib, dh),
                   (f + 1) * 4 + x_t.nnz * 8 + n * hidden * 4
                   + f * hidden * 4, 2 * x_t.nnz * hidden)
    recs["spmm_csr_bwd"] = dict(bwd, max_abs_err=max(bwd["max_abs_err"],
                                                     bwd_x["max_abs_err"]),
                                fc1=bwd_x)
    # what the edge kernel's second pass relies on: Âᵀ's entry j is Â's
    # entry fwd_pos[j], with the same value and edge id
    pos = a_t.fwd_pos.long()
    if not (torch.equal(a_t.val, a.val[pos])
            and torch.equal(a_t.edge_ids(), a.edge_ids()[pos])):
        raise SystemExit("fwd_pos: Âᵀ's entries are not Â's edges")
    print(f"fwd_pos of Âᵀ: val_t == val[fwd_pos] and ids_t == "
          f"ids[fwd_pos] on all {a.nnz} entries")
    # the serial epoch's K planes of Â and Âᵀ, recorded right before K3 as
    # in earlier runs: K3's time depends on what the card ran just before
    # it (PERF.md), so its context stays the same
    keep = 1.0 - prop.drop_prob
    edge_serial = edge_mask_record(
        f"edge masks (Â and Âᵀ, K={niter} planes)", a, a_t, niter, keep,
        1.0 - alpha, 7)
    keys = prng.split(prng.fold_in(prng.PRNGKey(0), 7), niter)
    planes, planes_t = edge_masks(keys, a, a_t, keep=keep,
                                  scale=1.0 - alpha)
    # K3 forward: K steps in one launch, shared (1-α)Â plane; no single
    # PyTorch call computes K steps, so there is no library time. Beside
    # it: one iteration, the same K steps as K queued K1 launches, K3 on
    # an edgeless operator of the same n and K (launch, waits and stores
    # without gathers), and K3 with K per-iteration planes (the train
    # forward of a fused epoch).
    planes1 = ws[None]
    edgeless = CsrMatrix(
        row_ptr=torch.zeros(n + 1, dtype=torch.int32, device=dev),
        col=torch.zeros(0, dtype=torch.int32, device=dev),
        val=torch.zeros(0, dtype=torch.float32, device=dev),
        n_rows=n, n_cols=n)

    def one_edge(cols):
        """n rows of one edge each, row i to cols[i], weight 1."""
        return CsrMatrix(
            row_ptr=torch.arange(n + 1, dtype=torch.int32, device=dev),
            col=cols.to(torch.int32).to(dev),
            val=torch.ones(n, dtype=torch.float32, device=dev),
            n_rows=n, n_cols=n)

    # one edge a row: to itself (each band waits on itself alone), or to
    # a random row (each band waits on nearly all): the cost of the waits
    # with almost nothing to gather
    diagonal = one_edge(torch.arange(n))
    scattered = one_edge(torch.from_numpy(rng.permutation(n)))

    def k3(op, planes_, steps=niter):
        return lambda: appnp_fused(op, h, alpha=alpha, niter=steps,
                                   e_w_all=planes_)

    def k1_chain(planes_):
        def run():
            x = h
            for k in range(niter):
                x = spmm_csr(a, x, planes_[k % planes_.shape[0]], init)
            return x
        return run

    recs["appnp_fused"] = record(
        "K3", k3(a, planes1),
        lambda: appnp_fused_plain(a, h, alpha=alpha, niter=niter,
                                  e_w_all=planes1),
        None, (n + 1) * 4 + a.nnz * 8 + 2 * n * c * 4,
        niter * (2 * a.nnz * c + 2 * n * c),
        niter1_ms=k3(a, planes1, 1), k1_chain_ms=k1_chain(planes1),
        edgeless_ms=k3(edgeless, None), diagonal_ms=k3(diagonal, None),
        scattered_ms=k3(scattered, None), k_planes_ms=k3(a, planes),
        k1_chain_k_planes_ms=k1_chain(planes))
    exact = [("K3 forward, shared plane", k3(a, planes1), k1_chain(planes1)),
             ("K3 forward, K planes", k3(a, planes), k1_chain(planes))]
    # K3 adjoint: the train-mode VJP on Âᵀ with the K planes reversed
    rev = torch.flip(planes_t, dims=(0,))

    def k1_bwd_chain():
        out, m = alpha * g, g
        for s in range(niter):
            m = spmm_csr_bwd(a_t, m, rev[s])
            out = out + (alpha if s + 1 < niter else 1.0) * m
        return out

    def adjoint():
        return appnp_fused(a_t, g, alpha=alpha, niter=niter, e_w_all=rev,
                           mode="adjoint")

    recs["appnp_adjoint"] = record(
        "K3 adjoint", adjoint,
        lambda: appnp_fused_plain(a_t, g, alpha=alpha, niter=niter,
                                  e_w_all=rev, mode="adjoint"),
        None, (n + 1) * 4 + a_t.nnz * 4 + niter * a_t.nnz * 4
        + 2 * n * c * 4, niter * (2 * a_t.nnz * c + 2 * n * c),
        k1_bwd_chain_ms=k1_bwd_chain)
    exact.append(("K3 adjoint", adjoint, k1_bwd_chain))
    # K3 against the same K steps as queued K1 launches, bit for bit:
    # every element is the same fmaf chain in CSR order
    failed = []
    for name, kernel, chain in exact:
        out, ref = kernel(), chain()
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        print(f"{name}: {'bit-equal' if same else 'NOT bit-equal'} to "
              f"{niter} queued {'K1-backward' if 'adjoint' in name else 'K1'}"
              f" launches (max abs diff "
              f"{float((out - ref).abs().max()):.3g})")
        if not same:
            failed.append(name)
    for name, extra in embedding_width_records(dev, a, alpha, niter, ws,
                                               rng).items():
        recs[name].update(extra, max_abs_err=max(
            [recs[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in extra.values()]))
    del planes
    # the other mask shapes last: their plain versions at G·K planes are
    # the longest calls timed here
    recs.update(mask_records(dev, graph, prop, x, x_t, edge_serial))
    return recs, failed


def embedding_width_records(dev, a, alpha, niter, ws, rng):
    """K3 and the K1 step at the retrieval width, c = HIDDEN columns of
    H on MS Academic's Â with the shared (1-α)Â plane (the hidden table
    of ``retrieve`` and the serving table build). K3 is held bit-equal to
    K queued K1 launches before anything is timed; then both are timed
    beside their plain versions, K1 also beside ``torch.addmm`` on the
    CSR. Returns {"spmm_csr": {"step_c64": ...}, "appnp_fused": {"c64":
    ...}} to merge into the c = 15 records."""
    from ppnp_tpu_torch.kernels.fused import appnp_fused, appnp_fused_plain
    from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_csr_plain

    n, c = a.n_rows, HIDDEN
    h = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dev)
    init = alpha * h
    planes1 = ws[None]

    def k3():
        return appnp_fused(a, h, alpha=alpha, niter=niter, e_w_all=planes1)

    def k1_chain():
        x = h
        for _ in range(niter):
            x = spmm_csr(a, x, ws, init)
        return x

    out, ref = k3(), k1_chain()
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise SystemExit(f"K3 at c = {c}: not bit-equal to {niter} queued "
                         "K1 launches (max abs diff "
                         f"{float((out - ref).abs().max()):.3g})")
    print(f"K3 forward at c = {c}, shared plane: bit-equal to {niter} "
          "queued K1 launches")
    a_lib = csr_tensor(a, ws)
    step = record(f"K1 step (c = {c})", lambda: spmm_csr(a, h, ws, init),
                  lambda: spmm_csr_plain(a, h, ws, init),
                  lambda: torch.addmm(init, a_lib, h),
                  (n + 1) * 4 + a.nnz * 8 + 3 * n * c * 4,
                  2 * a.nnz * c + n * c)
    fused = record(f"K3 (c = {c})", k3,
                   lambda: appnp_fused_plain(a, h, alpha=alpha, niter=niter,
                                             e_w_all=planes1),
                   None, (n + 1) * 4 + a.nnz * 8 + 2 * n * c * 4,
                   niter * (2 * a.nnz * c + 2 * n * c), k1_chain_ms=k1_chain)
    return {"spmm_csr": {f"step_c{c}": step},
            "appnp_fused": {f"c{c}": fused}}


def edge_mask_record(name, m, m_t, n_planes, keep, scale, seed):
    """Edge masks of ``m`` and ``m_t`` (its transpose) at ``n_planes``
    planes, bit-equal to the plain version on the CPU and to a second
    launch; beside it ``m`` alone (the first pass: no barrier, no second
    pass), ``one_layout_ms``. The bound counts one draw per (plane, edge
    of ``m``)."""
    from ppnp_tpu_torch.kernels.masks import edge_masks, edge_masks_plain
    from ppnp_tpu_torch.ops import prng

    cpu = torch.device("cpu")
    keys = prng.split(prng.fold_in(prng.PRNGKey(0), seed), n_planes)
    want = edge_masks_plain(keys, m.to(cpu), m_t.to(cpu), keep=keep,
                            scale=scale)
    rec = record(name,
                 lambda: edge_masks(keys, m, m_t, keep=keep, scale=scale),
                 lambda: edge_masks_plain(keys, m, m_t, keep=keep,
                                          scale=scale), None,
                 5 * m.nnz * 4 + 2 * n_planes * m.nnz * 4, 0,
                 exact_ref=want,
                 int_ops=draw_ops(n_planes * m.nnz, DRAW_FIRST))
    rec["one_layout_ms"] = time_ms(
        lambda: edge_masks(keys, m, keep=keep, scale=scale))
    return rec


def mask_records(dev, graph, prop, x, x_t, edge_serial):
    """The mask kernels at every shape the main path launches them, each
    bit-equal to its plain version run on the CPU and to a second launch.
    Edge masks (``edge_mask_record``): Â + Âᵀ at K planes (the serial
    epoch's, ``edge_serial``, recorded before K3) and G·K (batched), X +
    Xᵀ at 1 plane (the fc1 draw) and G. Dense masks: the hidden layer
    (n × 64) for 1 key and for G keys (beside it, G single-key
    launches), and the xla arm's step masks over the EdgeList's slots for
    K keys (serial) and G·K (batched). Returns the records of
    ``edge_masks`` and ``dropout_mask``, headed by the serial epoch's
    shapes (Â + Âᵀ at K planes; n × 64, one key)."""
    from ppnp_tpu_torch.builders import build_propagator
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.masks import (dropout_mask, dropout_masks,
                                              dropout_masks_plain)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.dropout import quantized_keep
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS

    a, a_t, alpha, niter = prop.csr, prop.csr_t, prop.alpha, prop.niter
    groups, keep = len(DEFAULT_SEEDS), 1.0 - prop.drop_prob
    edge = dict(edge_serial, batched=edge_mask_record(
        f"edge masks (Â and Âᵀ, G·K={groups * niter} planes)", a, a_t,
        groups * niter, keep, 1.0 - alpha, 17),
        fc1=edge_mask_record("edge masks (X and Xᵀ, 1 plane)", x, x_t, 1,
                             keep, 1.0, 27),
        fc1_batched=edge_mask_record(
            f"edge masks (X and Xᵀ, G={groups} planes)", x, x_t, groups,
            keep, 1.0, 37))
    _, thresh = quantized_keep(prop.drop_prob)
    n, hidden = a.n_rows, 64

    def dense_rec(name, shape, n_keys, seed, **extra):
        keys = prng.split(prng.fold_in(prng.PRNGKey(0), seed), n_keys)
        words = int(np.prod(shape[:-1])) * -(-shape[-1] // 4)
        return record(
            name, lambda: (dropout_masks(keys, shape, thresh, dev),),
            lambda: (dropout_masks_plain(keys, shape, thresh, dev),), None,
            n_keys * int(np.prod(shape)), 0,
            exact_ref=(dropout_masks_plain(keys, shape, thresh),),
            int_ops=draw_ops(n_keys * words, DRAW_BOTH),
            **{k: fn(keys) for k, fn in extra.items()})

    # the hidden layer's mask of one epoch, one key through dropout_mask
    key = prng.fold_in(prng.PRNGKey(0), 8)
    shape = (n, hidden)
    dense = record(
        "dropout mask (n x 64, 1 key)",
        lambda: (dropout_mask(key, shape, thresh, dev),),
        lambda: (dropout_masks_plain([key], shape, thresh, dev)[0],), None,
        n * hidden, 0, exact_ref=(dropout_masks_plain([key], shape,
                                                      thresh)[0],),
        int_ops=draw_ops(n * hidden // 4, DRAW_BOTH))
    w_pad = build_propagator(RunConfig(dataset=DATASET, backend="xla"),
                             graph, device=dev).edges.w.shape
    dense.update(
        batched=dense_rec(
            f"dropout masks (n x 64, G={groups} keys)", shape, groups, 18,
            single_keys_ms=lambda keys: lambda: [
                dropout_mask(k, shape, thresh, dev) for k in keys]),
        xla_steps=dense_rec(f"dropout masks (xla step masks, {w_pad[0]} "
                            f"slots, K={niter} keys)", w_pad, niter, 28),
        xla_steps_batched=dense_rec(
            f"dropout masks (xla step masks, {w_pad[0]} slots, "
            f"G·K={groups * niter} keys)", w_pad, groups * niter, 38))
    return {"edge_masks": edge, "dropout_mask": dense}


# one Threefry draw, by difference: the same kernel with and without it
THREEFRY_PROBE = r"""
#include "common.cuh"
#define PROBE(name, expr)                                                \
  extern "C" __global__ void name(const unsigned* k, const unsigned* c,  \
                                  unsigned* out) {                       \
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;            \
    const unsigned k0 = k[0], k1 = k[1], k2 = k[2];                      \
    const unsigned c0 = c[2 * i], c1 = c[2 * i + 1];                     \
    out[i] = expr;                                                       \
  }
PROBE(none, k0 ^ k1 ^ k2 ^ c0 ^ c1)
PROBE(both_words, ppnp::threefry2x32(k0, k1, k2, c0, c1).x ^
                      ppnp::threefry2x32(k0, k1, k2, c0, c1).y ^ k0 ^ k1 ^ c0)
PROBE(first_word, ppnp::threefry2x32(k0, k1, k2, c0, c1).x ^ k0 ^ k1 ^ c0)
"""
INT_OPS = ("IADD3", "IMAD", "LOP3", "SHF", "VIADD", "LEA", "ISETP", "SEL",
           "PRMT", "IABS", "VIMNMX")


def sass_int_ops() -> None:
    """The 32-bit integer instructions of one Threefry draw in the built
    code: three probe kernels compiled as the kernels are (no draw; one draw using both words, as the dense masks do; the first
    word alone, as the edge masks do), counted by opcode in ``cuobjdump
    -sass``, the probe without a draw subtracted; IMAD issues on the FMA
    pipe, the rest on the INT32 lanes. Fails unless the counts are
    DRAW_BOTH and DRAW_FIRST, which the masks' bounds use."""
    import re

    from ppnp_tpu_torch.kernels import build

    nvcc = build._nvcc()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    (work / "threefry_probe.cu").write_text(THREEFRY_PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-I",
                    str(ROOT / "ppnp_tpu_torch" / "csrc"), "-o",
                    str(work / "threefry_probe.cubin"),
                    str(work / "threefry_probe.cu")], check=True)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(work / "threefry_probe.cubin")], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", fn)
        counts[fn.split("\n", 1)[0].strip()] = {
            op: ops.count(op) for op in INT_OPS}
    base = counts["none"]
    for name, want in (("both_words", DRAW_BOTH), ("first_word", DRAW_FIRST)):
        diff = {op: counts[name][op] - base[op] for op in INT_OPS}
        got = (sum(diff.values()) - diff["IMAD"], diff["IMAD"])
        print(f"SASS of one Threefry draw ({name.replace('_', ' ')}): "
              f"{got[0]} integer instructions on the INT32 lanes, {got[1]} "
              "IMAD (FMA pipe); "
              + ", ".join(f"{op} {v}" for op, v in diff.items() if v))
        if got != want:
            raise SystemExit(f"SASS of one Threefry draw ({name}): {got} "
                             f"instructions by pipe, the bounds use {want}")


def k3_launch_report(dev):
    """K3's launch at MS Academic in each mode (and the forward at the
    hidden width): blocks, rows per band, the
    bands a block waits on before an iteration (hi − lo + 1, mean over
    blocks and max), and the shares of a block's clock cycles spent in its
    prologue and in its waits."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.fused import launch_shape

    cfg = RunConfig(dataset=DATASET, backend="pallas")
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    c = int(graph.labels.max()) + 1
    for mode, op, width in (("forward", prop.csr, c),
                            ("adjoint", prop.csr_t, c),
                            ("forward", prop.csr, HIDDEN)):
        shape = launch_shape(op, width, niter=prop.niter, mode=mode)
        print(f"K3 {mode} launch at c = {width}: " + ", ".join(
            f"{k}={v}" for k, v in shape.items()))


def grouped_kernel_phase(dev):
    """K2 at MS Academic with the G = 10 seeds of the sweep: the
    propagation step (cg = 15, 150 lanes, with init) and its backward on
    Âᵀ, the sparse fc1 (X with G planes, cg = 64, 640 lanes) and its
    backward on Xᵀ; each within the tolerance of the plain version and
    bit-equal to G K1 launches on the per-group slices. Also K1 at the
    batched eval's shapes: the step on the lane-stacked H (G·c = 150
    lanes, init, the one shared plane of (1-α)Â) and fc1 on the
    lane-stacked W₁ (G·hidden = 640 lanes). Returns the records of
    ``spmm_grouped`` and ``spmm_grouped_bwd``, and K1's batched-eval
    records under ``spmm_csr``."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.masks import edge_masks
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_grouped,
                                             spmm_csr_grouped_bwd,
                                             spmm_csr_grouped_plain,
                                             spmm_csr_plain)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS
    from ppnp_tpu_torch.train import prepare_attr_input

    cfg = RunConfig(dataset=DATASET, backend="pallas")
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    a, a_t, alpha = prop.csr, prop.csr_t, prop.alpha
    xin = prepare_attr_input(graph, prop, x_format="sparse")
    x, x_t = xin.csr, xin.csr_t
    n, f = x.n_rows, x.n_cols
    groups = len(DEFAULT_SEEDS)
    c, hidden = int(graph.labels.max()) + 1, 64
    keys = np.stack([prng.fold_in(prng.PRNGKey(s), 0) for s in DEFAULT_SEEDS])
    keep = 1.0 - prop.drop_prob
    planes, planes_t = edge_masks(keys, a, a_t, keep=keep, scale=1.0 - alpha)
    planes_x, planes_xt = edge_masks(keys, x, x_t, keep=keep)
    rng = np.random.RandomState(1)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.randn(*shape)).astype(np.float32)).to(dev)

    h, g = randn(n, groups * c), randn(n, groups * c)
    init = alpha * h
    w1s = randn(f, groups * hidden, scale=0.03)
    dh = randn(n, groups * hidden)
    print(f"K2 shapes: G={groups} | step n={n} nnz={a.nnz} lanes="
          f"{groups * c} | fc1 X {n}x{f} nnz={x.nnz} lanes={groups * hidden}")

    def per_group(op, h_, planes_, init_, cg):
        """G K1 launches on contiguous per-group slices (sliced here,
        outside the timed calls)."""
        sl = [slice(k * cg, (k + 1) * cg) for k in range(groups)]
        hs = [h_[:, s_].contiguous() for s_ in sl]
        inits = [None if init_ is None else init_[:, s_].contiguous()
                 for s_ in sl]

        def run():
            return [op(hs[k], planes_[k], inits[k]) for k in range(groups)]
        return run

    def coo_batch(m, planes_):
        """(G, rows, cols) sparse COO of the G masked weight sets."""
        rows = m.row_ids()
        idx = torch.stack([
            torch.arange(groups, device=dev).repeat_interleave(m.nnz),
            rows.repeat(groups), m.col.long().repeat(groups)])
        return torch.sparse_coo_tensor(
            idx, planes_.reshape(-1), (groups, m.n_rows, m.n_cols)).coalesce()

    def batched(h_, cg):
        return h_.view(h_.shape[0], groups, cg).permute(1, 0, 2).contiguous()

    def held(name, kernel, plain, library, bytes_moved, flops, k1_run):
        rec = record(name, kernel, plain, library, bytes_moved, flops,
                     k1_x_G_ms=k1_run)
        out, ref = kernel(), torch.cat(k1_run(), dim=1)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"{name}: not bit-equal to {groups} K1 "
                             "launches on the per-group slices")
        print(f"{name}: bit-equal to {groups} K1 launches")
        return rec

    def k1(m):
        return lambda h_, w, i: spmm_csr(m, h_, w, i)

    lanes = groups * c
    a_lib, hb = coo_batch(a, planes), batched(h, c)
    step = held("K2 step", lambda: spmm_csr_grouped(a, h, planes, init),
                lambda: spmm_csr_grouped_plain(a, h, planes, init),
                lambda: torch.bmm(a_lib, hb),
                (n + 1) * 4 + a.nnz * 4 + groups * a.nnz * 4
                + 3 * n * lanes * 4, 2 * a.nnz * lanes + n * lanes,
                per_group(k1(a), h, planes, init, c))
    x_lib, wb = coo_batch(x, planes_x), batched(w1s, hidden)
    lanes_x = groups * hidden
    fc1 = held("K2 fc1", lambda: spmm_csr_grouped(x, w1s, planes_x),
               lambda: spmm_csr_grouped_plain(x, w1s, planes_x),
               lambda: torch.bmm(x_lib, wb),
               (n + 1) * 4 + x.nnz * 4 + groups * x.nnz * 4
               + (f + n) * lanes_x * 4, 2 * x.nnz * lanes_x,
               per_group(k1(x), w1s, planes_x, None, hidden))
    at_lib, gb = coo_batch(a_t, planes_t), batched(g, c)
    bwd = held("K2 bwd step",
               lambda: spmm_csr_grouped_bwd(a_t, g, planes_t),
               lambda: spmm_csr_grouped_plain(a_t, g, planes_t),
               lambda: torch.bmm(at_lib, gb),
               (n + 1) * 4 + a_t.nnz * 4 + groups * a_t.nnz * 4
               + 2 * n * lanes * 4, 2 * a_t.nnz * lanes,
               per_group(k1(a_t), g, planes_t, None, c))
    xt_lib, dhb = coo_batch(x_t, planes_xt), batched(dh, hidden)
    bwd_x = held("K2 bwd fc1 (dW)",
                 lambda: spmm_csr_grouped_bwd(x_t, dh, planes_xt),
                 lambda: spmm_csr_grouped_plain(x_t, dh, planes_xt),
                 lambda: torch.bmm(xt_lib, dhb),
                 (f + 1) * 4 + x_t.nnz * 4 + groups * x_t.nnz * 4
                 + (n + f) * lanes_x * 4, 2 * x_t.nnz * lanes_x,
                 per_group(k1(x_t), dh, planes_xt, None, hidden))
    # K1 in the batched eval forward: K steps on the lane-stacked H with
    # the shared (1-α)Â weights, and fc1 on the lane-stacked W₁
    ws = prop.w_scaled
    a_lib1 = csr_tensor(a, ws)
    eval_step = record(f"K1 eval step ({lanes} lanes)",
                       lambda: spmm_csr(a, h, ws, init),
                       lambda: spmm_csr_plain(a, h, ws, init),
                       lambda: torch.addmm(init, a_lib1, h),
                       (n + 1) * 4 + a.nnz * 8 + 3 * n * lanes * 4,
                       2 * a.nnz * lanes + n * lanes)
    x_lib1 = csr_tensor(x, x.val)
    eval_fc1 = record(f"K1 eval fc1 ({lanes_x} lanes)",
                      lambda: spmm_csr(x, w1s),
                      lambda: spmm_csr_plain(x, w1s),
                      lambda: torch.sparse.mm(x_lib1, w1s),
                      (n + 1) * 4 + x.nnz * 8 + (f + n) * lanes_x * 4,
                      2 * x.nnz * lanes_x)
    return {
        "spmm_csr": {"eval_step": eval_step, "eval_fc1": eval_fc1},
        "spmm_grouped": dict(step, max_abs_err=max(step["max_abs_err"],
                                                   fc1["max_abs_err"]),
                             fc1=fc1),
        "spmm_grouped_bwd": dict(bwd, max_abs_err=max(bwd["max_abs_err"],
                                                      bwd_x["max_abs_err"]),
                                 fc1=bwd_x),
    }


def serving_path(dev):
    """Phase 4: ``predict`` through every backend; returns launch counts
    per backend."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.checkpoint import save_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import init_mlp_params, ppnp_forward
    from ppnp_tpu_torch.train import prepare_attr_input

    graph = load_graph(RunConfig(dataset=DATASET))
    n, f = graph.attr_matrix.shape
    n_classes = int(graph.labels.max()) + 1
    gen = torch.Generator().manual_seed(0)
    model = init_mlp_params(f, [64], n_classes, generator=gen, device=dev)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    ckpt = ROOT / "build" / "chip_smoke"
    save_checkpoint(str(ckpt), 0, {"params": state, "best_state": state,
                                   "epoch": 0,
                                   "early_stopping": {"best_epoch": 0}})

    expected = {"xla": {"spmm_csr": 1, "appnp_fused": 0},
                "pallas": {"spmm_csr": 11, "appnp_fused": 0},
                "fused": {"spmm_csr": 1, "appnp_fused": 1}}
    launches, preds, request_ms = {}, {}, {}
    for b in ("xla", "pallas", "fused"):
        out_npz = ckpt / f"preds_{b}.npz"
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["predict", "--dataset", DATASET, "--backend", b,
                           "--device", str(dev),
                           "--checkpoint-dir", str(ckpt), "--out",
                           str(out_npz), "--requests", str(REQUESTS)])
        launches[b] = dict(build.LAUNCHES)
        if rc != 0:
            raise SystemExit(f"predict --backend {b} exited {rc}")
        res = json.loads(buf.getvalue())
        preds[b] = np.load(out_npz)["predictions"]
        request_ms[b] = res["request_ms"]
        print(f"predict --backend {b}: n={res['n']} "
              f"request_ms={[round(t, 3) for t in res['request_ms']]} "
              f"launches={launches[b]}")
        want = {k: expected[b].get(k, 0) * REQUESTS
                for k in build.LAUNCHES}
        if launches[b] != want:
            raise SystemExit(f"predict --backend {b}: launches "
                             f"{launches[b]}, expected {want}")
        if preds[b].shape != (n,) or preds[b].min() < 0 \
                or preds[b].max() >= n_classes:
            raise SystemExit(f"predict --backend {b}: bad predictions")
    for b in ("pallas", "fused"):
        agree = float((preds[b] == preds["xla"]).mean())
        print(f"argmax agreement {b} vs xla: {agree:.6f}")
        if agree < AGREE:
            raise SystemExit(f"{b} agrees with xla on {agree} < {AGREE}")

    # log-probs of the three arms on one input, outside the counted run:
    # the xla arm (plain torch ops, no kernel) against a float64
    # numpy/scipy forward, the kernel arms against the xla arm; then where
    # a request's time goes, per arm
    logp = {}
    for b in ("xla", "pallas", "fused"):
        prop = build_propagator(RunConfig(dataset=DATASET, backend=b), graph,
                                device=dev)
        x = prepare_attr_input(graph, prop)
        with torch.no_grad():
            logp[b] = ppnp_forward(model, x, prop)
        wall, busy, top = profile_requests(model, x, prop)
        median = float(np.median(request_ms[b][1:]))
        if not top:
            print(f"profile --backend {b}: the profiler saw no device "
                  "time; device busy share not measured")
            continue
        print(f"profile --backend {b}: device busy {busy:.4f} ms/request "
              f"= {busy / median:.3f} of the median request "
              f"({median:.4f} ms, requests 2..{REQUESTS}); "
              f"{wall:.4f} ms/request under the profiler; by device time: "
              + "; ".join(f"{k} x{cnt} {ms:.4f} ms" for k, cnt, ms in top))
    ref = reference_logp(graph, state, prop.alpha, prop.niter)
    err = float((logp["xla"].double().cpu() - ref).abs().max())
    print(f"log-probs xla vs float64 reference: max_abs_err={err:.3g} "
          f"(tol {REF_TOL})")
    torch.testing.assert_close(logp["xla"].double().cpu(), ref,
                               rtol=REF_TOL, atol=REF_TOL)
    for b in ("pallas", "fused"):
        err = compare(f"log-probs {b} vs xla", logp[b], logp["xla"])
        print(f"log-probs {b} vs xla: max_abs_err={err:.3g}")
    # K3 is bit-equal to K queued K1 launches, so the two kernel arms agree
    # bit for bit
    same = torch.equal(logp["fused"], logp["pallas"])
    print(f"log-probs fused vs pallas: {'bit-equal' if same else 'differ'}")
    if not same:
        raise SystemExit("log-probs of the fused and pallas arms differ")
    return launches


def launches_per_epoch(backend: str, niter: int) -> dict:
    """Kernel launches of one training epoch with sparse X: the train
    forward and backward, then the stopping-set eval forward.

    Masks: one edge_masks launch draws X's and Xᵀ's plane, one draws Â's
    and Âᵀ's K planes (pallas, fused); the hidden layer's dropout is one
    dropout_mask launch, and on the xla arm one more draws the K step
    masks over the EdgeList's values.
    """
    if backend == "pallas":
        return {"spmm_csr": 1 + niter + 1 + niter,
                "spmm_csr_bwd": niter + 1, "edge_masks": 2,
                "dropout_mask": 1}
    if backend == "fused":
        return {"spmm_csr": 2, "spmm_csr_bwd": 1, "appnp_fused": 2,
                "appnp_adjoint": 1, "edge_masks": 2, "dropout_mask": 1}
    return {"spmm_csr": 2, "spmm_csr_bwd": 1, "edge_masks": 1,
            "dropout_mask": 2}


# the final evaluation after training: one eval forward
FINAL_EVAL = {"pallas": {"spmm_csr": 11}, "fused": {"spmm_csr": 1,
                                                    "appnp_fused": 1},
              "xla": {"spmm_csr": 1}}


def training_path(dev):
    """Phase 5: ``train`` through every backend; returns launch counts
    per backend and ms per epoch per backend."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.kernels import build

    launches, epoch_ms, ckpts = {}, {}, {}
    for b, epochs in EPOCHS.items():
        ckpt = ROOT / "build" / "chip_smoke" / f"train_{b}"
        metrics = ckpt.with_suffix(".jsonl")
        for old in (metrics,):
            if old.exists():
                old.unlink()
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["train", "--dataset", DATASET, "--backend", b,
                           "--x-format", "sparse", "--device", str(dev),
                           "--max-epochs", str(epochs), "--patience",
                           "100", "--print-interval", "0",
                           "--checkpoint-dir", str(ckpt),
                           "--metrics-out", str(metrics)])
        launches[b] = dict(build.LAUNCHES)
        if rc != 0:
            raise SystemExit(f"train --backend {b} exited {rc}")
        res = json.loads(buf.getvalue())
        rows = [json.loads(line) for line in metrics.read_text().splitlines()]
        rows = [r for r in rows if r["event"] == "epoch"]
        losses = [r["train_loss"] for r in rows]
        if len(rows) != epochs or res["last_epoch"] != epochs - 1:
            raise SystemExit(f"train --backend {b}: {len(rows)} epochs, "
                             f"last_epoch {res['last_epoch']}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"train --backend {b}: loss not finite and "
                             f"falling: {losses}")
        per = launches_per_epoch(b, res["config"]["niter"])
        want = {k: per.get(k, 0) * epochs + FINAL_EVAL[b].get(k, 0)
                for k in build.LAUNCHES}
        if launches[b] != want:
            raise SystemExit(f"train --backend {b}: launches "
                             f"{launches[b]}, expected {want}")
        ts = np.array([r["ts"] for r in rows])
        epoch_ms[b] = float(np.median(np.diff(ts[1:]))) * 1e3
        ckpts[b] = ckpt
        print(f"train --backend {b}: {epochs} epochs, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, valtest acc "
              f"{res['valtest']['accuracy']:.4f}, ms/epoch (median of "
              f"epochs 2..{epochs - 1}, host clock) {epoch_ms[b]:.3f}, "
              f"launches per epoch {per}")
    for b in ("pallas", "fused"):
        serve_checkpoint(dev, ckpts[b], b)
    for b in ("pallas", "fused"):
        epoch_on_card_vs_cpu(dev, b)
    for b in EPOCHS:
        profile_epochs(dev, b)
    return launches, epoch_ms


def serve_checkpoint(dev, ckpt, trained_on: str) -> None:
    """``predict`` serves a trained checkpoint on every arm with the same
    argmax (≥ AGREE of the nodes against xla)."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    preds = {}
    for b in ("xla", "pallas", "fused"):
        out_npz = ckpt.with_name(f"{ckpt.name}_preds_{b}.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["predict", "--dataset", DATASET, "--backend", b,
                           "--x-format", "sparse", "--device", str(dev),
                           "--checkpoint-dir", str(ckpt), "--out",
                           str(out_npz)])
        if rc != 0:
            raise SystemExit(f"predict of the {trained_on}-trained "
                             f"checkpoint on {b} exited {rc}")
        preds[b] = np.load(out_npz)["predictions"]
    for b in ("pallas", "fused"):
        agree = float((preds[b] == preds["xla"]).mean())
        print(f"checkpoint trained on {trained_on}: predict {b} vs xla "
              f"argmax agreement {agree:.6f}")
        if agree < AGREE:
            raise SystemExit(f"{b} agrees with xla on {agree} < {AGREE}")


def profile_epochs(dev, backend: str, reps: int = 5) -> None:
    """Where a training epoch's time goes: ``reps`` epochs (train forward,
    backward, Adam, stopping eval, one device-to-host read) under
    ``torch.profiler`` after two unprofiled ones: host-clock ms per
    epoch, device busy ms per epoch and its share, the largest device
    items and the largest host items (self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                             ppnp_forward)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.optim import Adam
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import (_mean, _nll, default_idx_split_args,
                                      prepare_attr_input)

    cfg = RunConfig(dataset=DATASET, backend=backend)
    graph = load_graph(cfg)
    labels = np.asarray(graph.labels)
    idx, idx_stop, _ = gen_splits(labels, default_idx_split_args)
    prop = build_propagator(cfg, graph, device=dev)
    x = prepare_attr_input(graph, prop, x_format="sparse")
    key_init, key_epochs = prng.split(prng.PRNGKey(0))
    model = init_mlp_params(x.shape[1], [64], int(labels.max()) + 1,
                            key=key_init, device=dev)
    params = [lin.weight for lin in model.layers]
    adam = Adam(params)
    i, i_stop = (torch.from_numpy(a).to(dev) for a in (idx, idx_stop))
    y, y_stop = (torch.from_numpy(labels[a]).long().to(dev)
                 for a in (idx, idx_stop))

    def epoch(e):
        logp = ppnp_forward(model, x, prop, i,
                            key=prng.fold_in(key_epochs, e), train=True)
        loss = _nll(logp, y) + 5e-3 / 2.0 * l2_reg(model)
        adam.step(torch.autograd.grad(loss, params))
        with torch.no_grad():
            logp = ppnp_forward(model, x, prop, i_stop)
            acc = _mean((logp.argmax(dim=-1) == y_stop).float())
            return torch.stack([loss.detach(), acc,
                                _nll(logp, y_stop)]).tolist()

    for e in range(2):
        epoch(e)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for e in range(2, 2 + reps):
            epoch(e)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in on_card) / 1e3 / reps
    top_dev = sorted(on_card, key=lambda e: -e.device_time_total)[:4]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    top_host = sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"profile train --backend {backend}: {wall:.3f} ms/epoch under "
          f"the profiler, device busy {busy:.4f} ms/epoch "
          f"({busy / wall:.3f}); by device time: "
          + "; ".join(f"{e.key[:40]} x{e.count // reps} "
                      f"{e.device_time_total / 1e3 / reps:.4f} ms"
                      for e in top_dev)
          + " | by host self time: "
          + "; ".join(f"{e.key[:40]} x{e.count // reps} "
                      f"{e.self_cpu_time_total / 1e3 / reps:.4f} ms"
                      for e in top_host))


def epoch_on_card_vs_cpu(dev, backend: str) -> None:
    """One training epoch's loss and weight gradients on the card (the
    kernels) against the same epoch on the CPU (the plain versions) from
    the same key and weights."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                             ppnp_forward)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import (_nll, default_idx_split_args,
                                      prepare_attr_input)

    cfg = RunConfig(dataset=DATASET, backend=backend)
    graph = load_graph(cfg)
    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, default_idx_split_args)
    n_classes = int(labels.max()) + 1
    key_init, key_epochs = prng.split(prng.PRNGKey(0))
    key = prng.fold_in(key_epochs, 3)
    out = []
    for d in (torch.device("cpu"), dev):
        prop = build_propagator(cfg, graph, device=d)
        x = prepare_attr_input(graph, prop, x_format="sparse")
        model = init_mlp_params(x.shape[1], [64], n_classes, key=key_init,
                                device=d)
        i = torch.from_numpy(idx).to(d)
        y = torch.from_numpy(labels[idx]).long().to(d)
        logp = ppnp_forward(model, x, prop, i, key=key, train=True)
        loss = _nll(logp, y) + 5e-3 / 2.0 * l2_reg(model)
        loss.backward()
        out.append((loss.item(), [lin.weight.grad.cpu()
                                  for lin in model.layers]))
    (l_cpu, g_cpu), (l_card, g_card) = out
    err = [float((a - b).abs().max()) for a, b in zip(g_card, g_cpu)]
    print(f"one epoch ({backend}) card vs CPU: loss {l_card:.7f} vs "
          f"{l_cpu:.7f}, grad max_abs_err {err}")
    np.testing.assert_allclose(l_card, l_cpu, rtol=RTOL, atol=ATOL)
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def profile_requests(model, x, prop, reps: int = REQUESTS):
    """One arm's requests under ``torch.profiler``: host-clock ms per
    request, device busy ms per request (the sum of its kernels' and
    copies' device time), and the four largest device items as
    (name, count per request, ms per request)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ppnp_tpu_torch.train import get_predictions
    get_predictions(model, x, prop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            get_predictions(model, x, prop)
        wall = (time.perf_counter() - t0) * 1e3 / reps
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in on_card) / 1e3 / reps
    top = sorted(on_card, key=lambda e: -e.device_time_total)[:4]
    return wall, busy, [(e.key[:48], e.count // reps,
                         e.device_time_total / 1e3 / reps) for e in top]


def reference_logp(graph, state, alpha: float, niter: int) -> torch.Tensor:
    """The eval forward in float64 with numpy and scipy alone: L1-normed
    X → fc1 → ReLU → fc2 → K steps of (1-α)ÂH + αH⁰ → log-softmax."""
    h = reference_table(graph, state, alpha, niter, "logits")
    h = h - h.max(axis=1, keepdims=True)
    return torch.from_numpy(h - np.log(np.exp(h).sum(axis=1,
                                                     keepdims=True)))


def reference_table(graph, state, alpha: float, niter: int,
                    level: str) -> np.ndarray:
    """K steps of (1-α)ÂH + αH⁰ in float64 with numpy and scipy alone,
    from H⁰ = ReLU(L1-normed X → fc1) (``level="hidden"``) or its fc2
    logits (``"logits"``)."""
    import scipy.sparse as sp
    attr = sp.csr_matrix(graph.attr_matrix, dtype=np.float64)
    rows = np.asarray(attr.sum(axis=1)).ravel()
    attr = sp.diags(np.where(rows > 0, 1.0 / np.maximum(rows, 1e-12), 0.0)) \
        @ attr
    w1 = state["layers.0.weight"].double().numpy()
    h0 = np.maximum(attr @ w1.T, 0.0)
    if level == "logits":
        h0 = h0 @ state["layers.1.weight"].double().numpy().T
    adj = sp.csr_matrix(graph.adj_matrix, dtype=np.float64)
    adj = adj + sp.eye(adj.shape[0], format="csr")
    d = sp.diags(1.0 / np.sqrt(np.asarray(adj.sum(axis=1)).ravel()))
    a_hat = (d @ adj @ d).tocsr()
    h = h0
    for _ in range(niter):
        h = (1.0 - alpha) * (a_hat @ h) + alpha * h0
    return h


def sweep_launches_per_epoch(backend: str, niter: int, groups: int) -> dict:
    """Kernel launches of one batched epoch (G seeds, sparse X): the train
    forward and backward, then the stopping-set eval forward.

    pallas: K2 for the masked fc1 and each of the K steps, forward and
    backward; the eval is K1 on the lane-stacked W₁ and K steps of K1 at
    G·c lanes; one mask launch draws X's G planes, and the G·K planes of
    Â and Âᵀ take one launch per 256; the G dense dropout masks of the
    hidden layer one launch. xla: the same fc1, the propagation in plain
    torch ops with its G·K slot-keyed step masks in one launch per 256."""
    def per_256(keys):
        return -(-keys // 256)   # kernels/masks.py MAX_KEYS_PER_LAUNCH

    if backend == "pallas":
        return {"spmm_grouped": niter + 1, "spmm_grouped_bwd": niter + 1,
                "spmm_csr": niter + 1,
                "edge_masks": 1 + per_256(groups * niter),
                "dropout_mask": per_256(groups)}
    return {"spmm_grouped": 1, "spmm_grouped_bwd": 1, "spmm_csr": 1,
            "edge_masks": 1,
            "dropout_mask": per_256(groups) + per_256(groups * niter)}


def run_reproduce(dev, args, name: str):
    """``reproduce`` in process with the launch counts set to 0 just
    before and read just after; returns (launches, metrics rows, wall s,
    stdout)."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.kernels import build

    metrics = ROOT / "build" / "chip_smoke" / f"{name}.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    if metrics.exists():
        metrics.unlink()
    buf = io.StringIO()
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["reproduce", *args, "--device", str(dev),
                       "--print-interval", "0",
                       "--metrics-out", str(metrics)])
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"reproduce {name} exited {rc}")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    return launches, [r for r in rows if r["event"] == "epoch"], wall, \
        buf.getvalue()


def seed_sweep_path(dev):
    """The seed sweep: ``reproduce`` on MS Academic, sparse X, the 10
    default seeds in ONE batch on the pallas and xla arms, then a few
    serial epochs of 2 seeds; asserts launch counts per batched epoch,
    finite and falling per-seed losses, and the batched losses of those 2
    seeds against the serial runs. Returns launch counts per run."""
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS

    groups, niter = len(DEFAULT_SEEDS), 10
    common = ["--datasets", DATASET, "--x-format", "sparse", "--patience",
              "100"]
    launches, losses, epoch_ms = {}, {}, {}
    for b, epochs in SWEEP_EPOCHS.items():
        args = [*common, "--backend", b, "--nseeds", str(groups),
                "--max-epochs", str(epochs)]
        got, rows, wall, out = run_reproduce(dev, args, f"sweep_{b}")
        launches[f"reproduce {b}"] = got
        per = sweep_launches_per_epoch(b, niter, groups)
        final = {"spmm_csr": niter + 1 if b == "pallas" else 1}
        want = {k: per.get(k, 0) * epochs + final.get(k, 0)
                for k in got}
        if got != want or len(rows) != epochs:
            raise SystemExit(f"reproduce {b}: {len(rows)} epochs, launches "
                             f"{got}, expected {want}")
        loss = np.array([r["train_loss"] for r in rows])   # (E, G)
        if not np.isfinite(loss).all() or not (loss[-1] < loss[0]).all():
            raise SystemExit(f"reproduce {b}: per-seed losses not finite "
                             f"and falling: {loss[0]} -> {loss[-1]}")
        ts = np.array([r["ts"] for r in rows])
        epoch_ms[b] = float(np.median(np.diff(ts[1:]))) * 1e3
        losses[b] = loss
        print(f"reproduce {b}: G={groups} in one batch, {epochs} epochs, "
              f"{wall:.2f} s; {out.splitlines()[0]}; loss per seed "
              f"{np.round(loss[0], 4).tolist()} -> "
              f"{np.round(loss[-1], 4).tolist()}; ms per batched epoch "
              f"(median of epochs 2..{epochs - 1}, host clock) "
              f"{epoch_ms[b]:.3f}; launches per epoch {per}")

    args = [*common, "--backend", "pallas", "--nseeds", str(SERIAL_SEEDS),
            "--serial-seeds", "--max-epochs", str(SERIAL_EPOCHS)]
    got, rows, wall, _ = run_reproduce(dev, args, "sweep_serial")
    launches["reproduce serial"] = got
    per = launches_per_epoch("pallas", niter)
    want = {k: (per.get(k, 0) * SERIAL_EPOCHS
                + FINAL_EVAL["pallas"].get(k, 0)) * SERIAL_SEEDS
            for k in got}
    if got != want:
        raise SystemExit(f"reproduce serial: launches {got}, expected "
                         f"{want}")
    serial_ms = []
    for g, seed in enumerate(DEFAULT_SEEDS[:SERIAL_SEEDS]):
        mine = [r for r in rows if r["seed"] == seed]
        serial = [r["train_loss"] for r in mine]
        batched = losses["pallas"][:SERIAL_EPOCHS, g]
        err = float(np.abs(np.array(serial) - batched).max())
        print(f"seed {seed}: serial losses {np.round(serial, 7).tolist()}, "
              f"batched max_abs_err {err:.3g} (tol {SWEEP_TOL})")
        np.testing.assert_allclose(batched, serial, rtol=SWEEP_TOL,
                                   atol=SWEEP_TOL)
        serial_ms += np.diff([r["ts"] for r in mine])[1:].tolist()
    one = float(np.median(serial_ms)) * 1e3
    print(f"batched epoch {epoch_ms['pallas']:.3f} ms for {groups} seeds vs "
          f"serial {one:.3f} ms per seed-epoch x {groups} = "
          f"{groups * one:.3f} ms (host clock, NVIDIA card above)")
    for b in SWEEP_EPOCHS:
        profile_batched_epochs(dev, b)
    return launches


def profile_batched_epochs(dev, backend: str, epochs=(2, 7)) -> None:
    """Where a batched epoch's time goes: ``train_models`` (the 10 seeds,
    sparse X) for ``epochs[0]`` and for ``epochs[1]`` epochs, each under
    ``torch.profiler``; the differences per extra epoch cancel the set-up
    and the final eval: host ms per epoch under the profiler, device busy
    ms per epoch and its share, the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.multiseed import train_models
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS
    from ppnp_tpu_torch.train import prepare_attr_input

    cfg = RunConfig(dataset=DATASET, backend=backend)
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    x = prepare_attr_input(graph, prop, x_format="sparse")
    runs = []
    for e in epochs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_models(graph, prop, DEFAULT_SEEDS, x_prepared=x,
                         x_format="sparse", test=True,
                         stopping_args={"max_epochs": e, "patience": 100})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        runs.append((wall, {ev.key: (ev.count, ev.device_time_total / 1e3)
                            for ev in prof.key_averages()
                            if ev.device_type == DeviceType.CUDA}))
    d = epochs[1] - epochs[0]
    (w0, k0), (w1, k1) = runs
    per = {k: ((k1.get(k, (0, 0))[0] - k0.get(k, (0, 0))[0]) / d,
               (k1.get(k, (0, 0))[1] - k0.get(k, (0, 0))[1]) / d)
           for k in set(k0) | set(k1)}
    wall = (w1 - w0) / d
    busy = sum(ms for _, ms in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:5]
    print(f"profile batched epoch --backend {backend} (G={len(DEFAULT_SEEDS)}, "
          f"{epochs[1]} minus {epochs[0]} epochs): {wall:.3f} ms/epoch under "
          f"the profiler, device busy {busy:.4f} ms/epoch "
          f"({busy / wall:.3f}); by device time: "
          + "; ".join(f"{k[:40]} x{cnt:g} {ms:.4f} ms"
                      for k, (cnt, ms) in top))


def exact_path(dev):
    """Exact PPNP: BASELINE's exact Citeseer config as a 2-seed
    ``reproduce`` sweep (dense Π, dropout on the selected rows through the
    dense mask kernel), then ``calc_ppr_exact`` once at the PubMed
    surrogate's n, timed and checked by its residual."""
    from ppnp_tpu_torch.builders import load_graph, resolve_alpha
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.ops.exact import _dense_m, calc_ppr_exact
    from ppnp_tpu_torch.ops.normalize import calc_A_hat

    args = ["--propagation", "exact", "--datasets", "citeseer", "--nseeds",
            "2", "--max-epochs", str(EXACT_EPOCHS), "--patience", "100"]
    got, rows, wall, out = run_reproduce(dev, args, "exact_citeseer")
    # per seed and epoch: dropout on X, on the hidden layer, on Π[idx]
    want = {k: 0 for k in got}
    want["dropout_mask"] = 3 * EXACT_EPOCHS * 2
    if got != want or len(rows) != 2 * EXACT_EPOCHS:
        raise SystemExit(f"reproduce exact: {len(rows)} epoch rows, "
                         f"launches {got}, expected {want}")
    loss = [r["train_loss"] for r in rows]
    if not np.isfinite(loss).all():
        raise SystemExit(f"reproduce exact: non-finite loss {loss}")
    print(f"reproduce exact citeseer: 2 seeds x {EXACT_EPOCHS} epochs, "
          f"{wall:.2f} s; {out.splitlines()[0]}")

    cfg = RunConfig(dataset="pubmed")
    a_hat = calc_A_hat(load_graph(cfg).adj_matrix)
    alpha = resolve_alpha(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppr = calc_ppr_exact(a_hat, alpha, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = ppr.shape[0]
    resid = _dense_m(a_hat, alpha, dev) @ ppr
    resid.diagonal().sub_(alpha)
    err = float(resid.abs().max())
    print(f"calc_ppr_exact pubmed: n={n}, Pi {n * n * 4 / 1e9:.2f} GB, "
          f"{secs:.3f} s (host clock, incl. densifying M); residual "
          f"max|M Pi - alpha I| = {err:.3g} (tol {EXACT_RESID})")
    if not torch.isfinite(ppr).all() or err > EXACT_RESID:
        raise SystemExit("calc_ppr_exact: non-finite or residual too large")
    return {"reproduce exact": got}


def retrieval_path(dev):
    """Retrieval on the pallas-trained checkpoint's best weights: the
    hidden table (densified X, as the ``retrieve`` CLI builds it) on the
    fused, pallas and xla arms, each in one call with the launch counts
    set to 0 just before and read just after (one K3 launch; K K1
    launches; none); the fused table bit-equal to the pallas one, the
    xla one within REF_TOL of a float64 forward; ``retrieve_topk`` on
    QUERIES noisy table rows with its top-1 equal to a float64 numpy
    oracle on ≥ AGREE of them; then the ``retrieve`` CLI once on the
    fused arm. Returns launch counts per path."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.checkpoint import restore_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import MLP
    from ppnp_tpu_torch.retrieval import build_embedding_table, retrieve_topk
    from ppnp_tpu_torch.train import prepare_attr_input

    state = restore_checkpoint(str(ROOT / "build" / "chip_smoke"
                                   / "train_pallas"))
    weights = state["best_state"]
    model = MLP.from_state_dict(weights, device=dev)
    graph = load_graph(RunConfig(dataset=DATASET))
    n = graph.num_nodes()
    expected = {"fused": {"appnp_fused": 1}, "pallas": {"spmm_csr": 10},
                "xla": {}}
    launches, tables = {}, {}
    for b in ("fused", "pallas", "xla"):
        prop = build_propagator(RunConfig(dataset=DATASET, backend=b), graph,
                                device=dev)
        x = prepare_attr_input(graph, prop, x_format="dense")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        tables[b] = build_embedding_table(model, x, prop, level="hidden")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[f"retrieve {b}"] = got = dict(build.LAUNCHES)
        del x
        want = {k: expected[b].get(k, 0) for k in got}
        print(f"hidden table on {b}: {tuple(tables[b].shape)}, {ms:.3f} ms "
              f"(one call, host clock), launches {got}")
        if got != want or tables[b].shape != (n, HIDDEN) \
                or not torch.isfinite(tables[b]).all():
            raise SystemExit(f"hidden table on {b}: launches {got}, "
                             f"expected {want}, or a bad table")
    same = torch.equal(tables["fused"], tables["pallas"])
    print(f"hidden table fused vs pallas: "
          f"{'bit-equal' if same else 'differ'}")
    if not same:
        raise SystemExit("hidden tables of the fused and pallas arms differ")
    err = compare("hidden table pallas vs xla", tables["pallas"],
                  tables["xla"])
    ref = reference_table(graph, weights, prop.alpha, prop.niter, "hidden")
    ref_err = float(np.abs(tables["xla"].double().cpu().numpy() - ref).max())
    print(f"hidden table: pallas vs xla max_abs_err={err:.3g}; xla vs "
          f"float64 reference max_abs_err={ref_err:.3g} (tol {REF_TOL})")
    np.testing.assert_allclose(tables["xla"].double().cpu().numpy(), ref,
                               rtol=REF_TOL, atol=REF_TOL)

    table = tables["fused"]
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randint(0, n, QUERIES)).to(dev)
    q = table[src] + 0.01 * torch.from_numpy(
        rng.randn(QUERIES, HIDDEN).astype(np.float32)).to(dev)
    scores, idx = retrieve_topk(q, table, k=10)
    oracle = (q.double().cpu().numpy()
              @ table.double().cpu().numpy().T).argmax(axis=1)
    agree = float((idx[:, 0].cpu().numpy() == oracle).mean())
    print(f"retrieve_topk: {QUERIES} noisy queries, top-1 equal to the "
          f"float64 oracle on {agree:.6f} (need {AGREE})")
    if agree < AGREE or not (scores[:, :-1] >= scores[:, 1:]).all():
        raise SystemExit(f"retrieve_topk: top-1 agreement {agree} < "
                         f"{AGREE} or scores not descending")

    buf = io.StringIO()
    build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["retrieve", "--dataset", DATASET, "--backend", "fused",
                       "--x-format", "sparse", "--device", str(dev),
                       "--max-epochs", str(RETRIEVE_EPOCHS), "--patience",
                       "100", "--print-interval", "0", "--nqueries", "5"])
    launches["retrieve cli fused"] = got = dict(build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"retrieve exited {rc}")
    per = launches_per_epoch("fused", 10)
    want = {k: per.get(k, 0) * RETRIEVE_EPOCHS
            + FINAL_EVAL["fused"].get(k, 0) + expected["fused"].get(k, 0)
            for k in got}
    lines = [line for line in buf.getvalue().splitlines()
             if line.startswith("query node")]
    print(f"retrieve --backend fused ({RETRIEVE_EPOCHS} epochs): "
          f"launches {got}; " + (lines[0] if lines else "no lines"))
    if got != want or len(lines) != 5:
        raise SystemExit(f"retrieve: {len(lines)} query lines, launches "
                         f"{got}, expected {want}")
    return launches


def _errors(res) -> list:
    """Paths of every ``"error"`` key in a bench result."""
    if not isinstance(res, dict):
        return []
    return [k for k in res if k == "error"] + [
        f"{k}.{e}" for k, v in res.items() for e in _errors(v)]


def bench_path(dev):
    """Every ported bench once, on the card, at small iteration counts:
    propagation on the three arms (c = 128, K = 100, MS Academic), the
    c-sweep, serving and retrieval on MS Academic, training and its
    breakdown on pallas and fused, exact PPNP on PubMed, and the host
    ingest at its default size. Each result is printed as one JSON line;
    the run fails on any ``"error"`` entry or a result that is not
    right. Returns launch counts per bench."""
    from ppnp_tpu_torch import benchmarks as bm
    from ppnp_tpu_torch.kernels import build

    arms = ("xla", "pallas", "fused")
    prop_iters = 3
    runs = [
        ("propagation", lambda: bm.bench_propagation(
            dataset=DATASET, c=128, niter=100, iters=prop_iters,
            backends=arms, device=dev)),
        ("c_sweep", lambda: bm.bench_c_sweep(
            dataset=DATASET, niter=100, iters=2, backends=arms, device=dev)),
        ("serving", lambda: bm.bench_serving(dataset=DATASET, iters=10,
                                             device=dev)),
        ("retrieval", lambda: bm.bench_retrieval(dataset=DATASET, iters=5,
                                                 device=dev)),
        *[(f"training {b}", lambda b=b: bm.bench_training(
            dataset=DATASET, backend=b, epochs=20, epoch_chunk=10,
            device=dev)) for b in ("pallas", "fused")],
        *[(f"training_breakdown {b}", lambda b=b: bm.bench_training_breakdown(
            dataset=DATASET, backend=b, iters=5, device=dev))
          for b in ("pallas", "fused")],
        ("exact", lambda: bm.bench_exact(dataset="pubmed", iters=5,
                                         device=dev)),
        ("ingest", bm.bench_ingest),
    ]
    launches, results = {}, {}
    for name, run in runs:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"bench {name}"] = dict(build.LAUNCHES)
        results[name] = res
        print(json.dumps({"bench": name, "seconds": secs, "result": res},
                         default=float))
        if _errors(res):
            raise SystemExit(f"bench {name}: error entries {_errors(res)}")
    # what must hold of the results: every arm timed, each K3 call one
    # launch and each pallas call K = 100 K1 launches (a warm-up call and
    # 3 trials of iters calls), the kernels launched where they run
    calls = 1 + 3 * prop_iters
    got = launches["bench propagation"]
    if (got["appnp_fused"], got["spmm_csr"]) != (calls, 100 * calls):
        raise SystemExit(f"bench propagation: launches {got}, expected "
                         f"{calls} K3 and {100 * calls} K1")
    for name, res in results.items():
        if name in ("propagation", "serving"):
            for b, v in res["backends"].items():
                if not all(np.isfinite(x) and x > 0 for x in v.values()):
                    raise SystemExit(f"bench {name} {b}: {v}")
    sweep = results["c_sweep"]["sweep"]
    if sorted(sweep) != [16, 64, 128, 256] or any(
            set(row) != {*arms, "speedup_vs_xla"} for row in sweep.values()):
        raise SystemExit(f"bench c_sweep: {sweep}")
    if results["retrieval"]["oracle_top1_agreement"] < AGREE:
        raise SystemExit("bench retrieval: top-1 agreement "
                         f"{results['retrieval']['oracle_top1_agreement']}")
    if not results["exact"]["residual_max"] <= EXACT_RESID:
        raise SystemExit(f"bench exact: residual "
                         f"{results['exact']['residual_max']}")
    for b in ("pallas", "fused"):
        res = results[f"training {b}"]
        if res["epochs"] != 20 or not res["s_per_epoch"] > 0:
            raise SystemExit(f"bench training {b}: {res}")
        kern = {"pallas": "spmm_csr", "fused": "appnp_fused"}[b]
        for path in (f"bench training {b}", f"bench training_breakdown {b}"):
            if launches[path][kern] == 0:
                raise SystemExit(f"{path}: no {kern} launch")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # the port comes from the checkout this script sits in; without it
    # the import fails here, before anything is printed
    from ppnp_tpu_torch.kernels import build
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("allow_tf32 must be False (full-f32 matmuls)")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = build.build_kernels()
    for name in build.SOURCES:
        build.load_library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(build.SOURCES.values())})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  nvcc {name}: {line.strip()}")
    sass_int_ops()

    recs, not_exact = kernel_phases(dev)
    grouped = grouped_kernel_phase(dev)
    k1_eval = grouped.pop("spmm_csr")
    recs["spmm_csr"].update(k1_eval, max_abs_err=max(
        [recs["spmm_csr"]["max_abs_err"]]
        + [r["max_abs_err"] for r in k1_eval.values()]))
    recs.update(grouped)
    if not_exact:
        raise SystemExit(f"not bit-equal to the K1 chain: {not_exact}")
    if "--kernels-only" in sys.argv[1:]:
        # phase 3 alone, to compare the kernels of two checkouts on one
        # card; no result line
        print(json.dumps({"kernel_records": recs}))
        return 0
    k3_launch_report(dev)
    launches = {f"predict {b}": v for b, v in serving_path(dev).items()}
    trained, epoch_ms = training_path(dev)
    launches.update({f"train {b}": v for b, v in trained.items()})
    print("ms per training epoch (host clock, NVIDIA card above): "
          + json.dumps(epoch_ms))
    launches.update(seed_sweep_path(dev))
    launches.update(exact_path(dev))
    launches.update(retrieval_path(dev))
    t0 = time.perf_counter()
    launches.update(bench_path(dev))
    print(f"bench phase: {time.perf_counter() - t0:.2f} s")

    meta = {
        "spmm_csr": ("cuda", "ppnp_tpu_torch/csrc/spmm.cu",
                     "ppnp_tpu/kernels/spmm.py:71"),
        "spmm_csr_bwd": ("cuda", "ppnp_tpu_torch/csrc/spmm.cu",
                         "ppnp_tpu/kernels/spmm.py:71"),
        "spmm_grouped": ("cuda", "ppnp_tpu_torch/csrc/spmm.cu",
                         "ppnp_tpu/kernels/spmm.py:113"),
        "spmm_grouped_bwd": ("cuda", "ppnp_tpu_torch/csrc/spmm.cu",
                             "ppnp_tpu/kernels/spmm.py:113"),
        "appnp_fused": ("cuda", "ppnp_tpu_torch/csrc/fused.cu",
                        "ppnp_tpu/kernels/fused.py:84"),
        "appnp_adjoint": ("cuda", "ppnp_tpu_torch/csrc/fused.cu",
                          "ppnp_tpu/kernels/fused.py:84"),
        "edge_masks": ("cuda", "ppnp_tpu_torch/csrc/masks.cu",
                       "ppnp_tpu/ops/dropout.py:59"),
        "dropout_mask": ("cuda", "ppnp_tpu_torch/csrc/masks.cu",
                         "ppnp_tpu/ops/dropout.py:22"),
    }
    kernels = []
    for name, rec in recs.items():
        total = sum(launches[p][name] for p in launches)
        if total == 0:
            raise SystemExit(f"{name} was never launched on the main path")
        route, source, replaces = meta[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=total,
            launches_by_path={p: launches[p][name] for p in launches},
            **rec))
    print("mask launches over the run: " + ", ".join(
        f"{k['name']} {k['launches']}" for k in kernels
        if k["name"] in ("edge_masks", "dropout_mask")))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          "included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
