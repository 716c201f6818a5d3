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
   fc1 (640 lanes) and its backward on Xᵀ, and at G = 100 (the
   benchmark sweep's 1,500 lanes, slots straddling two seeds) at the step
   and its backward, and bit for bit against G K1 launches on the
   per-group slices, with the launches' vector width and straddling; K1 also at the batched sweep's eval
   shapes (the step at G·c = 150 lanes with init and one shared plane,
   fc1 at G·hidden = 640 lanes); and at the retrieval width c = 64 on
   Â: K3 (shared plane) held bit-equal to K queued K1 launches before it
   is timed, and the K1 step, each beside its plain version (K1 also
   beside ``torch.addmm``); and K1 forward and backward at the operator
   shapes of the blocked arm (each block of the default plan, on H's
   window as a row view) and of an S = 4 row partition (each shard's
   interior and boundary operators, the received rows gathered from a
   full H; each rank's row-sharded sparse fc1, X_r and X_rᵀ at hidden
   64) and of a 2 × 2 hierarchical plan (each rank's ici and dcn
   operators), the stitched blocked step bit-equal to one K1 launch on
   the whole operator and the stitched sharded and hierarchical steps
   within 1e-5 of it; the dense masks of sharded training: dense X at
   world size 1, and a rank's rows of X and of the hidden layer drawn
   from a nonzero row offset, bit-equal to the plain version and to
   those rows of the offset-0 draw, and a draw across 2^32 words;
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
10. blocked: ``predict --backend blocked`` on the serving checkpoint
   (n_blocks·K + 1 K1 launches a request, log-probs bit-equal to the
   pallas arm's, device µs per step beside it), ``train --backend
   blocked`` (launches per epoch, a falling loss, one epoch on the card
   against the CPU) and ``bench --blocked-scale`` at its defaults
   (500 k nodes, 5 M edges, c = 128);
11. sharded, world size 1 on NCCL: the heartbeat; ``predict
   --propagation sharded`` on the xla and pallas arms (launch counts,
   log-probs within 1e-5 of the unsharded pallas arm on the same
   relabelled graph, device µs per step and the exchange's cost);
   ``bench --scaling`` on the PubMed surrogate at c = 128 on both arms;
   ``retrieve_topk_sharded`` and ``_qsharded`` against ``retrieve_topk``
   on a hidden table built sharded;
12. sharded training, world size 1 on NCCL: ``train --propagation
   sharded`` on the pallas arm with sparse X (``ShardedSparseInput``)
   and with dense X (20 epochs each) and on the xla arm with dense X
   (4); launches per epoch asserted, a falling loss, ms per epoch beside
   the unsharded pallas epoch of phase 5, and one epoch on the card
   against the same epoch on the CPU (a gloo group of the same process)
   for each; then the hierarchical propagator at D = I = 1, built
   directly, bit-equal to the flat world-size-1 arm in eval and train
   mode on both arms, serving the checkpoint (K K1 launches a request
   on pallas) with the flat sharded ``predict``'s predictions;
13. bf16 X and tracing, MS Academic at full width: fc1 as the f32
   product and as the mixed bf16 one (bf16 operands, f32 sums), its dW
   (X upcast, f32 product, rounded to bf16) and the dense dropout of X
   in f32 and bf16, each in device ms beside its bound (bf16 operations
   at BF16_FLOPS), held card against CPU (forward within rtol 1e-5, dW
   equal or one bf16 ulp apart, the bf16 dropout bit-equal) and the
   forward asserted to be one product of bf16 operands with no f32 copy
   of X; ``train --x-format dense --x-dtype bfloat16`` (20 epochs on
   pallas and fused, 4 on xla) beside the same runs on dense f32 X and
   phase 5's sparse f32 epochs, launch counts asserted; one bf16 epoch
   card vs CPU; ``predict --x-dtype bfloat16`` of the trained
   checkpoint against the CPU port's argmax (≥ 0.999) and against f32
   X; the batched bf16 sweep (G = 10) with its peak memory, and one
   batched epoch card vs CPU at Citeseer's size; a sharded bf16 epoch
   (world size 1, NCCL) card vs CPU; ``train --profile DIR --tensorboard
   DIR2`` over two chunks on pallas and fused (each trace parsed, its
   kernels and ``ppnp/*`` spans found, the K1 events kept counted
   against those launched; TensorBoard scalars equal to the JSONL rows
   where tensorboard imports), ``bench --training --profile``, the host
   µs of one ``annotate`` span with the profiler off and on, and the
   fused arm's request ms beside phase 4's; prints the records as one
   ``{"library_products": ...}`` line;
14. the public surface and the example: ``ppnp_tpu_torch.ops.spmm`` on
   its pallas arm (one K1 launch) within 1e-5 of its xla arm at phase 3's
   Â and c = 15; ``examples/simple_example_torch.py``'s ``main`` in
   process on the xla, pallas and fused arms for up to 300 epochs (Cora-ML
   at full width: launches per epoch and of the final eval and the hidden
   table asserted, a finite and falling loss, the pallas and fused arms'
   final stopping loss within 1e-5; each arm's top-5 of nodes 0-2 those
   of a float64 table of its own weights, and the pallas arm's weights
   giving the same top-5 through every arm, wherever neighbouring scores
   differ by more than 1e-5; ms per epoch and valtest accuracy printed);
   ``build_sparse_input`` on MS
   Academic's X, its CSR arrays equal to the ``SparseInput`` that
   ``train`` stages;
15. training at 500k nodes: ``scripts/blocked_train_torch.py``'s ``run``
   in process at the JAX script's defaults (n = 500,000, nnz(Â) ≈ 10.5 M,
   f = 512, 16 classes, hidden 64, K = 10, α = 0.1, 16,384 rows a block,
   no reorder, 150 epochs, patience 100): ``auto`` picks dense X, the
   launches per epoch (K1 2·K per block forward, K per block backward,
   one edge-mask launch per block, two dense dropout masks), a finite
   and falling loss, valtest accuracy ≥ 0.95, seconds for generation,
   ingest and training, s/epoch and peak memory printed; three epochs
   profiled; one epoch card vs CPU on 4 blocks of the same generator; K1
   forward and backward on one 500 k block at c = 16 and 64 and the
   dense dropout mask of the 500,000 × 512 X, each beside its plain
   version and bound (the mask bit-equal);
16. print one ``{"kernels": [...]}`` line (launches per path, the
   ``retrieve <arm>``, ``bench <name>``, ``predict blocked``, ``train
   blocked``, ``bench blocked``, ``predict sharded <arm>``, ``bench
   scaling <arm>``, ``train sharded <arm> <X layout>``, ``predict
   hier <arm>``, ``train dense <dtype> <arm>``, ``reproduce bf16
   pallas``, ``train profile <arm>``, ``bench training profile``,
   ``spmm pallas``, ``example <arm>`` and ``blocked_train 500k`` paths
   included), then the card
   line, then ``{"ok": true, "device":
   {...}}`` as the last line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout (the package is imported from the checkout). With
``--kernels-only`` it runs phases 1–3 alone and prints their records
instead of a result: run it in two checkouts, in turns, to compare their
kernels on one card.
"""

import contextlib
import io
import json
import shutil
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
SLOW_MS = 20.0         # calls slower than this are timed alone (time_ms)
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


def queued_ms(fn, inner: int = 20, reps: int = 11, warmup: int = 3):
    """(device ms of one ``fn()`` call, host ms to enqueue one call,
    host-bound): CUDA events around ``inner`` calls queued behind a sleep
    kernel, so that the host has enqueued them before the first one
    starts and its launch overhead is hidden; medians over ``reps``. When
    enqueueing the ``inner`` calls took longer than the sleep kernel ran
    (its own pair of events), the card may have waited for the host, and
    the first number is host time: host-bound is then True. A call that
    waits for the host (the plain versions do) is timed with that wait.
    A call slower than SLOW_MS (the plain versions at the larger mask
    shapes, dense X's among them) is timed alone, 3 times: queueing
    hides nothing there, and 11 x 20 of it would keep the card busy for
    seconds to minutes and heat it before the next kernel is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if call_ms(fn, reps=1, warmup=0) > SLOW_MS:
        inner, reps = 1, 3
    times, enqueue, slept = [], [], []
    for _ in range(reps):
        asleep = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        asleep.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
        slept.append(asleep.elapsed_time(start))
    host = float(np.median(enqueue))
    return (float(np.median(times)), host / inner,
            host > float(np.median(slept)))


def time_ms(fn, inner: int = 20, reps: int = 11, warmup: int = 3) -> float:
    """The first number of ``queued_ms``: device time of one call, or
    host time where the call waits for the host or its enqueueing
    outlasts the sleep (``queued_ms`` says which)."""
    return queued_ms(fn, inner, reps, warmup)[0]


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
    f32 operations and 32-bit integer instructions of the bound. The
    kernel's time must be device time: it raises where ``queued_ms``
    finds it host-bound."""
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
    ms, _, host_bound = queued_ms(kernel)
    if host_bound:
        raise SystemExit(f"{name}: enqueueing the timed launches outlasted "
                         "the sleep kernel; the time would be host time")
    rec = dict(max_abs_err=err, ms=ms,
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
    K keys (serial) and G·K (batched); and those of sharded training
    (``row_offset_records``). Returns the records of ``edge_masks`` and
    ``dropout_mask``, headed by the serial epoch's shapes (Â + Âᵀ at K
    planes; n × 64, one key)."""
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

    def dense_rec(name, shape, n_keys, seed, row_offset=0, **extra):
        keys = prng.split(prng.fold_in(prng.PRNGKey(0), seed), n_keys)
        words = int(np.prod(shape[:-1])) * -(-shape[-1] // 4)
        off = row_offset * -(-shape[-1] // 4)
        return record(
            name, lambda: (dropout_masks(keys, shape, thresh, dev, off),),
            lambda: (dropout_masks_plain(keys, shape, thresh, dev, off),),
            None, n_keys * int(np.prod(shape)), 0,
            exact_ref=(dropout_masks_plain(keys, shape, thresh, None, off),),
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
    dense.update(row_offset_records(dev, dense_rec, n, hidden, x.n_cols,
                                    thresh))
    return {"edge_masks": edge, "dropout_mask": dense}


def row_offset_records(dev, dense_rec, n, hidden, f, thresh):
    """The dense masks of sharded training: dense X at world size 1
    (n_pad x f, offset 0), and the last rank's rows [3S, 4S) of an S = 4
    row grid for X and the hidden layer, drawn from their row offset
    alone: each bit-equal to its plain version on the CPU and to those
    rows of the offset-0 draw of the whole (4S, width) array; and one
    draw whose words cross 2^32 (the counter's high word), bit-equal to
    the plain version."""
    from ppnp_tpu_torch.kernels.masks import (dropout_masks,
                                              dropout_masks_plain)
    from ppnp_tpu_torch.ops import prng

    n_pad = 8 * -(-n // 8)    # the row grid at 1 and 4 ranks
    s4 = 8 * -(-n // 32)
    recs = {"x_dense": dense_rec(f"dropout mask (dense X, {n_pad} x {f}, "
                                 "1 key)", (n_pad, f), 1, 48)}
    for name, width, seed in (("row_offset_x", f, 58),
                              ("row_offset_hidden", hidden, 68)):
        recs[name] = dense_rec(
            f"dropout mask (rows [{3 * s4}, {4 * s4}) of {4 * s4} x "
            f"{width}, from the row offset)", (s4, width), 1, seed,
            row_offset=3 * s4)
        keys = prng.split(prng.fold_in(prng.PRNGKey(0), seed), 1)
        part = dropout_masks(keys, (s4, width), thresh, dev,
                             3 * s4 * -(-width // 4))
        whole = dropout_masks(keys, (4 * s4, width), thresh, dev)
        if not torch.equal(part[0], whole[0, 3 * s4:]):
            raise SystemExit(f"dropout mask at a row offset ({width} "
                             "wide): not the rows of the whole draw")
        print(f"dropout mask at row offset {3 * s4} ({width} wide): "
              "bit-equal to rows [3S, 4S) of the offset-0 draw")
    keys = prng.split(prng.PRNGKey(78), 2)
    off = 2 ** 32 - 1000
    got = dropout_masks(keys, (200, 64), thresh, dev, off)
    if not torch.equal(got.cpu(), dropout_masks_plain(keys, (200, 64),
                                                      thresh, None, off)):
        raise SystemExit("dropout mask across 2^32 words: not bit-equal "
                         "to the plain version")
    print(f"dropout mask at word offset {off} (3,200 words across 2^32, "
          "2 keys): bit-equal to the plain version")
    return recs


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
    backward on Xᵀ; and at the benchmark sweep's G = 100 seeds the step
    (1,500 lanes, with init) and its backward on Âᵀ, where float4 slots
    straddle two seeds. Each within the tolerance of the plain version and
    bit-equal to G K1 launches on the per-group slices; each record keeps
    its launches' ``K2_SHAPES`` (vector width, straddling). Also K1 at the
    batched eval's shapes: the step on the lane-stacked H (G·c = 150
    lanes, init, the one shared plane of (1-α)Â) and fc1 on the
    lane-stacked W₁ (G·hidden = 640 lanes). Returns the records of
    ``spmm_grouped`` and ``spmm_grouped_bwd``, and K1's batched-eval
    records under ``spmm_csr``."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.masks import edge_masks
    from ppnp_tpu_torch.kernels.spmm import (K2_SHAPES, spmm_csr,
                                             spmm_csr_grouped,
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
        """One K1 launch per plane on contiguous per-group slices (sliced
        here, outside the timed calls)."""
        sl = [slice(k * cg, (k + 1) * cg) for k in range(planes_.shape[0])]
        hs = [h_[:, s_].contiguous() for s_ in sl]
        inits = [None if init_ is None else init_[:, s_].contiguous()
                 for s_ in sl]

        def run():
            return [op(hs[k], planes_[k], inits[k]) for k in range(len(sl))]
        return run

    def coo_batch(m, planes_):
        """(G, rows, cols) sparse COO of the G masked weight sets."""
        groups_ = planes_.shape[0]
        rows = m.row_ids()
        idx = torch.stack([
            torch.arange(groups_, device=dev).repeat_interleave(m.nnz),
            rows.repeat(groups_), m.col.long().repeat(groups_)])
        return torch.sparse_coo_tensor(
            idx, planes_.reshape(-1), (groups_, m.n_rows, m.n_cols)
        ).coalesce()

    def batched(h_, cg):
        return h_.view(h_.shape[0], -1, cg).permute(1, 0, 2).contiguous()

    def held(name, kernel, plain, library, bytes_moved, flops, k1_run):
        before = dict(K2_SHAPES)
        rec = record(name, kernel, plain, library, bytes_moved, flops,
                     k1_x_G_ms=k1_run)
        rec["k2_shapes"] = {f"{k[0]} vec={k[1]} straddles={k[2]}":
                            v - before.get(k, 0)
                            for k, v in K2_SHAPES.items()
                            if v > before.get(k, 0)}
        out, refs = kernel(), k1_run()
        torch.cuda.synchronize()
        if not torch.equal(out, torch.cat(refs, dim=1)):
            raise SystemExit(f"{name}: not bit-equal to {len(refs)} K1 "
                             "launches on the per-group slices")
        print(f"{name}: bit-equal to {len(refs)} K1 launches; "
              f"k2_shapes={rec['k2_shapes']}")
        return rec

    def k1(m):
        return lambda h_, w, i: spmm_csr(m, h_, w, i)

    def step_bytes(m, groups_, lanes_, dense):
        """row_ptr, col, the G planes, and ``dense`` (n × lanes) arrays."""
        return ((m.n_rows + 1) * 4 + m.nnz * 4 + groups_ * m.nnz * 4
                + dense * m.n_rows * lanes_ * 4)

    lanes = groups * c
    a_lib, hb = coo_batch(a, planes), batched(h, c)
    step = held("K2 step", lambda: spmm_csr_grouped(a, h, planes, init),
                lambda: spmm_csr_grouped_plain(a, h, planes, init),
                lambda: torch.bmm(a_lib, hb),
                step_bytes(a, groups, lanes, 3),
                2 * a.nnz * lanes + n * lanes,
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
               step_bytes(a_t, groups, lanes, 2), 2 * a_t.nnz * lanes,
               per_group(k1(a_t), g, planes_t, None, c))
    xt_lib, dhb = coo_batch(x_t, planes_xt), batched(dh, hidden)
    bwd_x = held("K2 bwd fc1 (dW)",
                 lambda: spmm_csr_grouped_bwd(x_t, dh, planes_xt),
                 lambda: spmm_csr_grouped_plain(x_t, dh, planes_xt),
                 lambda: torch.bmm(xt_lib, dhb),
                 (f + 1) * 4 + x_t.nnz * 4 + groups * x_t.nnz * 4
                 + (n + f) * lanes_x * 4, 2 * x_t.nnz * lanes_x,
                 per_group(k1(x_t), dh, planes_xt, None, hidden))
    # the benchmark sweep's 100 seeds: 1,500 lanes, float4 slots that
    # straddle two seeds' columns
    groups100 = 100
    lanes100 = groups100 * c
    keys100 = np.stack([prng.fold_in(prng.PRNGKey(s), 0)
                        for s in range(groups100)])
    planes100, planes100_t = edge_masks(keys100, a, a_t, keep=keep,
                                        scale=1.0 - alpha)
    h100, g100 = randn(n, lanes100), randn(n, lanes100)
    init100 = alpha * h100
    a_lib100 = coo_batch(a, planes100)
    hb100 = batched(h100, c)
    step100 = held(
        "K2 step (G=100)",
        lambda: spmm_csr_grouped(a, h100, planes100, init100),
        lambda: spmm_csr_grouped_plain(a, h100, planes100, init100),
        lambda: torch.bmm(a_lib100, hb100),
        step_bytes(a, groups100, lanes100, 3),
        2 * a.nnz * lanes100 + n * lanes100,
        per_group(k1(a), h100, planes100, init100, c))
    del a_lib100, hb100
    at_lib100, gb100 = coo_batch(a_t, planes100_t), batched(g100, c)
    bwd100 = held(
        "K2 bwd step (G=100)",
        lambda: spmm_csr_grouped_bwd(a_t, g100, planes100_t),
        lambda: spmm_csr_grouped_plain(a_t, g100, planes100_t),
        lambda: torch.bmm(at_lib100, gb100),
        step_bytes(a_t, groups100, lanes100, 2), 2 * a_t.nnz * lanes100,
        per_group(k1(a_t), g100, planes100_t, None, c))
    del at_lib100, gb100
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
        "spmm_grouped": dict(step, max_abs_err=max(
            step["max_abs_err"], fc1["max_abs_err"],
            step100["max_abs_err"]), fc1=fc1, step_g100=step100),
        "spmm_grouped_bwd": dict(bwd, max_abs_err=max(
            bwd["max_abs_err"], bwd_x["max_abs_err"],
            bwd100["max_abs_err"]), fc1=bwd_x, step_g100=bwd100),
    }


def serving_path(dev):
    """Phase 4: ``predict`` through every backend; returns launch counts
    per backend and each backend's request ms."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.checkpoint import save_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import init_mlp_params, ppnp_forward
    from ppnp_tpu_torch.train import (REQUEST_GRAPHS, prepare_attr_input,
                                      reset_request_graphs)

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
        reset_request_graphs()
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
              f"launches={launches[b]} request graphs={REQUEST_GRAPHS}")
        want = {k: expected[b].get(k, 0) * wrapper_runs(REQUESTS)
                for k in build.LAUNCHES}
        graphs = {"eager": 1, "captured": int(REQUESTS >= 2),
                  "replayed": max(REQUESTS - 2, 0)}
        if launches[b] != want or REQUEST_GRAPHS != graphs:
            raise SystemExit(f"predict --backend {b}: launches "
                             f"{launches[b]}, expected {want}; request "
                             f"graphs {REQUEST_GRAPHS}, expected {graphs}")
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
    return launches, request_ms


def wrapper_runs(requests: int) -> int:
    """The kernel wrappers' runs in ``requests`` requests of one operand
    set on a one-card propagator, in requests: the first eager, the
    second an eager run on the capture stream and the capture, the rest
    replays, which run none (``train.get_predictions``)."""
    return min(requests, 1) + 2 * (requests >= 2)


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
    """``profile_training_epochs`` of the smoke dataset with sparse X on
    ``backend``."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.train import prepare_attr_input

    cfg = RunConfig(dataset=DATASET, backend=backend)
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    x = prepare_attr_input(graph, prop, x_format="sparse")
    profile_training_epochs(f"train --backend {backend}", graph, prop, x,
                            reps)


def profile_training_epochs(name: str, graph, prop, x,
                            reps: int = 5) -> None:
    """Where a training epoch's time goes: ``reps`` epochs (train forward,
    backward, Adam, stopping eval, one device-to-host read) under
    ``torch.profiler`` after two unprofiled ones: host-clock ms per
    epoch, device busy ms per epoch and its share, the largest device
    items and the largest host items (self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                             ppnp_forward)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.optim import Adam
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import _mean, _nll, default_idx_split_args

    dev = prop.device
    labels = np.asarray(graph.labels)
    idx, idx_stop, _ = gen_splits(labels, default_idx_split_args)
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
    # the ppnp/* spans (``profiling.annotate``) are device-side regions,
    # not device work: left out of the busy sum
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.device_time_total for e in on_card) / 1e3 / reps
    top_dev = sorted(on_card, key=lambda e: -e.device_time_total)[:4]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    top_host = sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"profile {name}: {wall:.3f} ms/epoch under "
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
    the same key and weights, on the smoke dataset with sparse X."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig

    cfg = RunConfig(dataset=DATASET, backend=backend)
    graph = load_graph(cfg)
    one_epoch_card_vs_cpu(
        dev, backend, graph,
        lambda d: build_propagator(cfg, graph, device=d), "sparse")


def one_epoch_card_vs_cpu(dev, name: str, graph, make_prop,
                          x_format: str) -> None:
    """One epoch (seed 0's weights, epoch 3's key) of ``graph`` through
    ``make_prop(device)``'s propagator and X staged as ``x_format``, on
    the CPU and on the card: the loss within RTOL/ATOL, the weight
    gradients within GRAD_RTOL/GRAD_ATOL."""
    from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                             ppnp_forward)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import (_nll, default_idx_split_args,
                                      prepare_attr_input)

    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, default_idx_split_args)
    n_classes = int(labels.max()) + 1
    key_init, key_epochs = prng.split(prng.PRNGKey(0))
    key = prng.fold_in(key_epochs, 3)
    out = []
    for d in (torch.device("cpu"), dev):
        prop = make_prop(d)
        x = prepare_attr_input(graph, prop, x_format=x_format)
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
    print(f"one epoch ({name}) card vs CPU: loss {l_card:.7f} vs "
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
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
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
    # one x and propagator for every seed: the final evaluations are
    # requests of one operand set
    want = {k: per.get(k, 0) * SERIAL_EPOCHS * SERIAL_SEEDS
            + FINAL_EVAL["pallas"].get(k, 0) * wrapper_runs(SERIAL_SEEDS)
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
                            if ev.device_type == DeviceType.CUDA
                            and not ev.is_user_annotation}))
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


def read_rows(op) -> int:
    """The input rows an operator reads: its distinct columns (a block's
    window reaches into padding rows no edge reads, and a boundary
    operator's columns skip the shard's own block)."""
    return int(torch.unique(op.col).numel())


def operator_records(name, op, op_t, h, init, g, scale):
    """Forward (with init) and backward records of K1 on one operator at
    the weights ``scale·val``, each beside ``torch.addmm`` (forward) or
    ``torch.sparse.mm`` (backward); h is the operator's columns, g its
    rows' cotangent. The bound reads only the rows of h and g that an
    entry gathers."""
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_bwd,
                                             spmm_csr_plain)
    c = h.shape[1]
    w, w_t = scale * op.val, scale * op_t.val
    lib, lib_t = csr_tensor(op, w), csr_tensor(op_t, w_t)
    fwd = record(f"K1 {name}", lambda: spmm_csr(op, h, w, init),
                 lambda: spmm_csr_plain(op, h, w, init),
                 lambda: torch.addmm(init, lib, h),
                 (op.n_rows + 1) * 4 + op.nnz * 8
                 + (read_rows(op) + 2 * op.n_rows) * c * 4,
                 2 * op.nnz * c + op.n_rows * c)
    bwd = record(f"K1 bwd {name}", lambda: spmm_csr_bwd(op_t, g, w_t),
                 lambda: spmm_csr_plain(op_t, g, w_t),
                 lambda: torch.sparse.mm(lib_t, g),
                 (op_t.n_rows + 1) * 4 + op_t.nnz * 8
                 + (read_rows(op_t) + op_t.n_rows) * c * 4,
                 2 * op_t.nnz * c)
    print(f"K1 {name}: bound reads {read_rows(op)} of {op.n_cols} H rows "
          f"forward, {read_rows(op_t)} of {op_t.n_cols} cotangent rows "
          "backward")
    return fwd, bwd


def block_and_shard_records(dev):
    """K1 at the operator shapes of the blocked and the sharded paths on
    MS Academic (c = 15, the propagation step's shared (1-α) plane), each
    held against its plain version and timed beside its bound and
    ``torch.addmm`` (forward) or ``torch.sparse.mm`` (backward), as phase
    3 does: every block of the default plan (16,384 rows a block, on H's
    window as a row view), and the interior and boundary operators of
    every shard of an S = 4 partition of the RCM-relabelled graph, with
    the received rows gathered from a full H on the host side; the
    row-sharded sparse fc1 of each rank of that grid (X_r, S × f, and
    X_rᵀ at hidden 64); and the ici and dcn operators of each rank of a
    2 × 2 hierarchical plan. The stitched blocked step is held bit-equal
    to the unsharded K1 step and the stitched sharded and hierarchical
    steps within RTOL of it. Returns the forward and backward records to
    merge under ``spmm_csr`` and ``spmm_csr_bwd``."""
    from ppnp_tpu_torch.builders import load_graph, resolve_alpha
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.blocked import build_blocked_csr
    from ppnp_tpu_torch.kernels.spmm import (spmm_csr, spmm_csr_bwd,
                                             spmm_csr_plain)
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.ops.sparse import csr_from_scipy, rcm_permutation
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)

    cfg = RunConfig(dataset=DATASET)
    graph = load_graph(cfg)
    a_hat = calc_A_hat(graph.adj_matrix)
    alpha, n = resolve_alpha(cfg), a_hat.shape[0]
    c = int(graph.labels.max()) + 1
    rng = np.random.RandomState(3)

    def randn(rows):
        return torch.from_numpy(rng.randn(rows, c).astype(np.float32)).to(
            dev)

    fwd, bwd = {}, {}
    # the blocked plan of --backend blocked at its default rows_per_block
    bcsr = build_blocked_csr(a_hat, device=dev)
    r, hw = bcsr.rows_per_block, bcsr.hw
    print(f"blocked plan: {bcsr.n_blocks} blocks of {r} rows, H window "
          f"{hw}, col_lo {list(bcsr.col_lo)}, nnz per block "
          f"{[blk.nnz for blk in bcsr.blocks]}")
    hp, gp = randn(bcsr.n_pad), randn(bcsr.n_pad)
    hp[n:] = 0.0   # the padding rows of H⁰, as the blocked arm pads it
    init = alpha * hp
    for b, (blk, blk_t, lo) in enumerate(zip(bcsr.blocks, bcsr.blocks_t,
                                             bcsr.col_lo)):
        rows = slice(b * r, (b + 1) * r)
        fwd[f"block{b}"], bwd[f"block{b}"] = operator_records(
            f"blocked step, block {b} ({r} x {hw})", blk, blk_t,
            hp[lo:lo + hw], init[rows], gp[rows], 1.0 - alpha)
    a_rcm = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=dev)
    stitched = torch.cat([spmm_csr(blk, hp[lo:lo + hw],
                                   (1.0 - alpha) * blk.val,
                                   init[b * r:(b + 1) * r])
                          for b, (blk, lo) in enumerate(zip(bcsr.blocks,
                                                            bcsr.col_lo))])
    whole = spmm_csr(a_rcm, hp[:n].contiguous(), (1.0 - alpha) * a_rcm.val,
                     init[:n].contiguous())
    torch.cuda.synchronize()
    same = torch.equal(stitched[:n], whole)
    print(f"blocked step stitched from {bcsr.n_blocks} K1 launches vs one "
          f"K1 launch on the whole RCM operator: "
          f"{'bit-equal' if same else 'NOT bit-equal'}")
    if not same or stitched[n:].abs().max() != 0:
        raise SystemExit("the blocked step differs from the whole step")

    # an S = 4 partition of the graph relabelled as load_graph does for
    # --propagation sharded
    perm = rcm_permutation(a_hat)
    a_rel = a_hat[perm][:, perm].tocsr()
    sg = build_sharded_graph(a_rel, n_shards=4)
    s, nb = sg.shard_rows, sg.n_shards * sg.boundary
    print(f"sharded plan, S = 4: shard_rows {s}, boundary {sg.boundary}, "
          f"edges_pad {sg.edges_pad}, interior_pad {sg.interior_pad}")
    h, g = randn(sg.n_pad), randn(sg.n_pad)
    outs = []
    for d, op in enumerate(build_sharded_csr(sg, device=dev)):
        rows = slice(d * s, (d + 1) * s)
        # the rows this shard receives: block o = shard o's send list
        idx = (np.arange(sg.n_shards)[:, None] * s
               + sg.send_idx[:, d, :]).reshape(-1)
        recv = h.index_select(0, torch.from_numpy(idx).to(dev))
        h_loc, init_d = h[rows], alpha * h[rows]
        print(f"shard {d}: interior nnz {op.interior.nnz}, boundary nnz "
              f"{op.boundary.nnz} over {nb} received rows")
        fwd[f"shard{d}_interior"], bwd[f"shard{d}_interior"] = \
            operator_records(f"shard {d}/4 interior ({s} x {s})",
                             op.interior, op.interior_t, h_loc, init_d,
                             g[rows], 1.0 - alpha)
        out_i = spmm_csr(op.interior, h_loc, (1.0 - alpha) * op.interior.val,
                         init_d)
        fwd[f"shard{d}_boundary"], bwd[f"shard{d}_boundary"] = \
            operator_records(f"shard {d}/4 boundary ({s} x {nb})",
                             op.boundary, op.boundary_t, recv, out_i,
                             g[rows], 1.0 - alpha)
        outs.append(spmm_csr(op.boundary, recv,
                             (1.0 - alpha) * op.boundary.val, out_i))
    a_plain = csr_from_scipy(a_rel, device=dev)
    want = spmm_csr(a_plain, h[:n].contiguous(), (1.0 - alpha) * a_plain.val,
                    alpha * h[:n].contiguous())
    err = compare("sharded step (S = 4) stitched vs the unsharded step",
                  torch.cat(outs)[:n], want)
    print(f"sharded step stitched from 4 x 2 K1 launches vs one K1 launch "
          f"on the whole operator: max_abs_err={err:.3g} (tol {RTOL})")

    # the row-sharded sparse fc1 of each rank, S = 4, hidden 64
    from ppnp_tpu_torch.ops.sparse_input import build_sharded_sparse_input
    from ppnp_tpu_torch.preprocessing import normalize_attributes
    attr = normalize_attributes(graph.attr_matrix)[perm]   # relabelled
    f = attr.shape[1]
    w1 = torch.from_numpy((0.03 * rng.randn(f, HIDDEN)).astype(
        np.float32)).to(dev)
    dh = torch.from_numpy(rng.randn(s, HIDDEN).astype(np.float32)).to(dev)
    for d in range(4):
        xs = build_sharded_sparse_input(attr, shard_rows=s, n_shards=4,
                                        rank=d, device=dev)
        x, x_t = xs.csr, xs.csr_t
        lib, lib_t = csr_tensor(x, x.val), csr_tensor(x_t, x_t.val)
        fwd[f"fc1_shard{d}"] = record(
            f"K1 sharded fc1, rank {d}/4 ({s} x {f}, c = {HIDDEN})",
            lambda: spmm_csr(x, w1), lambda: spmm_csr_plain(x, w1),
            lambda: torch.sparse.mm(lib, w1),
            (s + 1) * 4 + x.nnz * 8 + (read_rows(x) + s) * HIDDEN * 4,
            2 * x.nnz * HIDDEN)
        bwd[f"fc1_shard{d}"] = record(
            f"K1 bwd sharded fc1 (dW), rank {d}/4 ({f} x {s})",
            lambda: spmm_csr_bwd(x_t, dh, x_t.val),
            lambda: spmm_csr_plain(x_t, dh, x_t.val),
            lambda: torch.sparse.mm(lib_t, dh),
            (f + 1) * 4 + x_t.nnz * 8 + (read_rows(x_t) + f) * HIDDEN * 4,
            2 * x_t.nnz * HIDDEN)
        print(f"sharded fc1 rank {d}/4: nnz {x.nnz}, reads {read_rows(x)} "
              f"of {f} W rows, {read_rows(x_t)} of {s} dH rows")

    # the ici and dcn parts of a 2 x 2 hierarchical plan (its interiors
    # are the S = 4 interiors above), each rank's chained step stitched
    from ppnp_tpu_torch.parallel.hier import (build_hier_csr,
                                              build_hier_sharded_graph)
    hg = build_hier_sharded_graph(a_rel, 2, 2)
    D = I = 2
    print(f"hierarchical plan 2 x 2: S {hg.shard_rows}, b_ici {hg.b_ici}, "
          f"b_dcn {hg.b_dcn}, interior/ici pads {hg.interior_pad}/"
          f"{hg.ici_pad}, edges_pad {hg.edges_pad}, comm {hg.comm}")
    outs = []
    for d, op in enumerate(build_hier_csr(hg, device=dev)):
        t, i = divmod(d, I)
        rows = slice(d * s, (d + 1) * s)
        # block j of the ici table: rank (t, j)'s list to position i;
        # block (j, u) of the dcn table: rank (u, j)'s list to slice t
        ici = np.concatenate([(t * I + j) * s + hg.send_idx_ici[t * I + j, i]
                              for j in range(I)])
        dcn = np.concatenate([(u * I + j) * s + hg.send_idx_dcn[u * I + j, t]
                              for j in range(I) for u in range(D)])
        tables = (h[rows], h.index_select(0, torch.from_numpy(ici).to(dev)),
                  h.index_select(0, torch.from_numpy(dcn).to(dev)))
        out = alpha * h[rows]
        for p, (m, m_t, table) in enumerate(zip(op.parts, op.parts_t,
                                                tables)):
            part = ("interior", "ici", "dcn")[p]
            if p > 0:
                fwd[f"hier{d}_{part}"], bwd[f"hier{d}_{part}"] = \
                    operator_records(
                        f"hier 2x2 rank {d} {part} ({s} x {m.n_cols})", m,
                        m_t, table, out, g[rows], 1.0 - alpha)
            out = spmm_csr(m, table, (1.0 - alpha) * m.val, out)
        outs.append(out)
    err = compare("hierarchical step (2 x 2) stitched vs the unsharded "
                  "step", torch.cat(outs)[:n], want)
    print(f"hierarchical step stitched from 4 x 3 K1 launches vs one K1 "
          f"launch on the whole operator: max_abs_err={err:.3g} "
          f"(tol {RTOL})")
    return fwd, bwd


BLOCKED_EPOCHS = 20   # train --backend blocked


def blocked_launches_per_epoch(niter: int, n_blocks: int,
                               x_format: str = "sparse") -> dict:
    """Kernel launches of one blocked training epoch: the pallas arm's,
    with each propagation step K1 once per block (forward and backward)
    and the step masks one launch per block (the K planes of the block
    and its transpose). Sparse X adds fc1's K1 in both forwards, its dW
    and X's edge masks; dense X adds a dropout_mask launch for X in their
    place (``bf16_launches_per_epoch``)."""
    if x_format == "dense":
        return {"spmm_csr": 2 * n_blocks * niter,
                "spmm_csr_bwd": n_blocks * niter, "edge_masks": n_blocks,
                "dropout_mask": 2}
    return {"spmm_csr": 1 + n_blocks * niter + 1 + n_blocks * niter,
            "spmm_csr_bwd": n_blocks * niter + 1,
            "edge_masks": 1 + n_blocks, "dropout_mask": 1}


def step_us(prop, h, niter: int) -> str:
    """µs per propagation step of one eval ``propagate`` call, 5 calls
    queued: device time, or host time where enqueueing the calls
    outlasted the sleep (labelled host-bound), beside the host µs a step
    takes to enqueue."""
    with torch.no_grad():
        ms, host_ms, host_bound = queued_ms(lambda: prop.propagate(h),
                                            inner=EXTRA_INNER)
    clock = "host-bound" if host_bound else "device"
    return (f"{ms * 1e3 / niter:.3f} ({clock}; enqueue "
            f"{host_ms * 1e3 / niter:.3f} host us a step)")


def blocked_path(dev):
    """The blocked backend: ``predict --backend blocked`` on the serving
    checkpoint (n_blocks·K + 1 K1 launches a request; log-probs
    bit-equal to the pallas arm's), device µs per step against the
    pallas arm, ``train --backend blocked`` (launches per epoch, a
    falling loss, one epoch on the card against the CPU), and ``bench
    --blocked-scale`` at its defaults. Returns launch counts per path."""
    from ppnp_tpu_torch import benchmarks as bm
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.checkpoint import restore_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import MLP, ppnp_forward
    from ppnp_tpu_torch.train import prepare_attr_input

    ckpt = ROOT / "build" / "chip_smoke"
    graph = load_graph(RunConfig(dataset=DATASET))
    n = graph.num_nodes()
    props = {b: build_propagator(RunConfig(dataset=DATASET, backend=b),
                                 graph, device=dev)
             for b in ("blocked", "pallas")}
    bcsr, niter = props["blocked"].blocked, props["blocked"].niter
    launches = {}
    out_npz = ckpt / "preds_blocked.npz"
    buf = io.StringIO()
    build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["predict", "--dataset", DATASET, "--backend",
                       "blocked", "--device", str(dev), "--checkpoint-dir",
                       str(ckpt), "--out", str(out_npz), "--requests",
                       str(REQUESTS)])
    launches["predict blocked"] = got = dict(build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"predict --backend blocked exited {rc}")
    want = {k: 0 for k in got}
    want["spmm_csr"] = (bcsr.n_blocks * niter + 1) * wrapper_runs(REQUESTS)
    res = json.loads(buf.getvalue())
    preds = np.load(out_npz)["predictions"]
    print(f"predict --backend blocked ({bcsr.n_blocks} blocks): "
          f"request_ms={[round(t, 3) for t in res['request_ms']]} "
          f"launches={got}")
    if got != want:
        raise SystemExit(f"predict --backend blocked: launches {got}, "
                         f"expected {want}")
    if not np.array_equal(preds, np.load(ckpt / "preds_pallas.npz")
                          ["predictions"]):
        raise SystemExit("predict --backend blocked: predictions differ "
                         "from the pallas arm's")
    state = restore_checkpoint(str(ckpt))
    model = MLP.from_state_dict(state["best_state"], device=dev)
    x = prepare_attr_input(graph, props["pallas"])
    with torch.no_grad():
        logp = {b: ppnp_forward(model, x, p) for b, p in props.items()}
    same = torch.equal(logp["blocked"], logp["pallas"])
    print(f"log-probs blocked vs pallas: {'bit-equal' if same else 'differ'}"
          f" (max abs diff "
          f"{float((logp['blocked'] - logp['pallas']).abs().max()):.3g})")
    if not same:
        raise SystemExit("log-probs of the blocked and pallas arms differ")
    h = torch.from_numpy(np.random.RandomState(4).randn(
        n, logp["pallas"].shape[1]).astype(np.float32)).to(dev)
    print("us per eval step (c = 15, K = 10 a call, 5 calls queued): "
          + ", ".join(f"{b} {step_us(p, h, niter)}"
                      for b, p in props.items()))

    ckpt_b = ROOT / "build" / "chip_smoke" / "train_blocked"
    metrics = ckpt_b.with_suffix(".jsonl")
    if metrics.exists():
        metrics.unlink()
    buf = io.StringIO()
    build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train", "--dataset", DATASET, "--backend", "blocked",
                       "--x-format", "sparse", "--device", str(dev),
                       "--max-epochs", str(BLOCKED_EPOCHS), "--patience",
                       "100", "--print-interval", "0", "--checkpoint-dir",
                       str(ckpt_b), "--metrics-out", str(metrics)])
    launches["train blocked"] = got = dict(build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"train --backend blocked exited {rc}")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    rows = [r for r in rows if r["event"] == "epoch"]
    losses = [r["train_loss"] for r in rows]
    per = blocked_launches_per_epoch(niter, bcsr.n_blocks)
    want = {k: per.get(k, 0) * BLOCKED_EPOCHS for k in got}
    want["spmm_csr"] += 1 + bcsr.n_blocks * niter   # the final evaluation
    ts = np.array([r["ts"] for r in rows])
    print(f"train --backend blocked: {len(rows)} epochs, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, ms/epoch (median, host "
          f"clock) {float(np.median(np.diff(ts[1:]))) * 1e3:.3f}, launches "
          f"per epoch {per}")
    if got != want or len(rows) != BLOCKED_EPOCHS:
        raise SystemExit(f"train --backend blocked: {len(rows)} epochs, "
                         f"launches {got}, expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"train --backend blocked: loss not finite and "
                         f"falling: {losses}")
    epoch_on_card_vs_cpu(dev, "blocked")

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = bm.bench_blocked(device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches["bench blocked"] = got = dict(build.LAUNCHES)
    print(json.dumps({"bench": "blocked", "seconds": secs, "result": res},
                     default=float))
    calls = 1 + 3 * 3   # a warm-up call and 3 trials of iters = 3 calls
    want_k1 = res["blocks"]["n_blocks"] * res["niter"] * calls
    if _errors(res) or got["spmm_csr"] != want_k1 or not all(
            np.isfinite(v) and v > 0 for b in res["backends"].values()
            for v in b.values()):
        raise SystemExit(f"bench blocked: {res}, launches {got}, expected "
                         f"{want_k1} K1")
    return launches


def sharded_path(dev):
    """The flat sharded path at world size 1 on NCCL: the heartbeat;
    ``predict --propagation sharded`` on the xla and pallas arms (2·K K1
    launches a request on pallas, none on xla), their log-probs within
    RTOL of the unsharded pallas arm on the same relabelled graph, device
    µs per step beside it and the exchange's cost; ``bench --scaling`` on
    the PubMed surrogate at c = 128 on both arms; the hidden table built
    sharded and ``retrieve_topk_sharded`` / ``_qsharded`` against
    ``retrieve_topk``. Returns launch counts per path."""
    import torch.distributed as dist

    from ppnp_tpu_torch import benchmarks as bm
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.checkpoint import restore_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import MLP, ppnp_forward
    from ppnp_tpu_torch.parallel.health import heartbeat
    from ppnp_tpu_torch.parallel.mesh import make_mesh
    from ppnp_tpu_torch.retrieval import (build_embedding_table,
                                          retrieve_topk,
                                          retrieve_topk_qsharded,
                                          retrieve_topk_sharded)
    from ppnp_tpu_torch.train import prepare_attr_input

    mesh = make_mesh(device=dev)
    if dist.get_backend() != "nccl" or mesh.world_size != 1:
        raise SystemExit(f"sharded phase: backend {dist.get_backend()}, "
                         f"world size {mesh.world_size}")
    print(f"heartbeat (NCCL, world size 1): "
          f"{heartbeat(mesh, timeout_s=60) * 1e3:.3f} ms")
    ckpt = ROOT / "build" / "chip_smoke"
    cfg = RunConfig(dataset=DATASET, propagation="sharded")
    graph = load_graph(cfg)   # relabelled by RCM, as the CLI loads it
    n = graph.num_nodes()
    model = MLP.from_state_dict(restore_checkpoint(str(ckpt))["best_state"],
                                device=dev)
    ref = build_propagator(RunConfig(dataset=DATASET, backend="pallas"),
                           graph, device=dev)
    with torch.no_grad():
        ref_logp = ppnp_forward(model, prepare_attr_input(
            graph, ref, x_format="dense"), ref)
    niter = ref.niter
    h = torch.from_numpy(np.random.RandomState(5).randn(
        n, ref_logp.shape[1]).astype(np.float32)).to(dev)
    launches = {}
    for b in ("xla", "pallas"):
        out_npz = ckpt / f"preds_sharded_{b}.npz"
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["predict", "--dataset", DATASET, "--propagation",
                           "sharded", "--backend", b, "--device", str(dev),
                           "--checkpoint-dir", str(ckpt), "--out",
                           str(out_npz), "--requests", str(REQUESTS)])
        launches[f"predict sharded {b}"] = got = dict(build.LAUNCHES)
        if rc != 0:
            raise SystemExit(f"predict --propagation sharded --backend {b} "
                             f"exited {rc}")
        want = {k: 0 for k in got}
        if b == "pallas":
            want["spmm_csr"] = 2 * niter * REQUESTS
        res = json.loads(buf.getvalue())
        preds = np.load(out_npz)["predictions"]
        agree = float((preds == ref_logp.argmax(-1).cpu().numpy()).mean())
        print(f"predict --propagation sharded --backend {b}: n={res['n']} "
              f"request_ms={[round(t, 3) for t in res['request_ms']]} "
              f"launches={got}; argmax equal to the unsharded pallas arm on "
              f"{agree:.6f}")
        if got != want or agree < AGREE:
            raise SystemExit(f"predict sharded {b}: launches {got}, "
                             f"expected {want}; agreement {agree}")
        prop = build_propagator(RunConfig(dataset=DATASET,
                                          propagation="sharded", backend=b),
                                graph, device=dev)
        x = prepare_attr_input(graph, prop)
        with torch.no_grad():
            logp = ppnp_forward(model, x, prop)[:n]
        err = compare(f"log-probs sharded {b} vs unsharded pallas", logp,
                      ref_logp)
        h_loc = torch.nn.functional.pad(h, (0, 0, 0, prop.n_rows - n))
        x_ms, x_host, x_bound = queued_ms(lambda: prop._exchange(h_loc))
        print(f"log-probs sharded {b} (world size 1) vs the unsharded "
              f"pallas arm: max_abs_err={err:.3g} (tol {RTOL}); us per "
              f"eval step {step_us(prop, h_loc, niter)} against "
              f"{step_us(ref, h, niter)} unsharded; the exchange "
              f"(all_to_all of {prop.graph.boundary} rows) {x_ms * 1e3:.3f} "
              f"us ({'host-bound' if x_bound else 'device'}; enqueue "
              f"{x_host * 1e3:.3f} host us)")
        del x

    for b in ("xla", "pallas"):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = bm.bench_scaling(dataset="pubmed", c=128, niter=10, iters=10,
                               backend=b, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"bench scaling {b}"] = got = dict(build.LAUNCHES)
        print(json.dumps({"bench": f"scaling {b}", "seconds": secs,
                          "result": res}, default=float))
        want_k1 = 2 * 10 * (1 + 3 * 10) if b == "pallas" else 0
        if set(res["shards"]) != {1} or got["spmm_csr"] != want_k1 \
                or not res["shards"][1]["steps_per_s"] > 0:
            raise SystemExit(f"bench scaling {b}: {res}, launches {got}")

    state = restore_checkpoint(str(ckpt / "train_pallas"))
    model = MLP.from_state_dict(state["best_state"], device=dev)
    prop = build_propagator(RunConfig(dataset=DATASET, propagation="sharded",
                                      backend="pallas"), graph, device=dev)
    table = build_embedding_table(model, prepare_attr_input(graph, prop),
                                  prop, level="hidden")
    rng = np.random.RandomState(0)
    q = table[torch.from_numpy(rng.randint(0, n, QUERIES)).to(dev)] \
        + 0.01 * torch.from_numpy(rng.randn(QUERIES, HIDDEN).astype(
            np.float32)).to(dev)
    want_s, want_i = retrieve_topk(q, table[:n], k=10)
    for name, fn in (("sharded", retrieve_topk_sharded),
                     ("qsharded", retrieve_topk_qsharded)):
        s, i = fn(q, table, 10, mesh=prop.mesh, n_valid=n)
        agree = float((i == want_i).float().mean())
        err = compare(f"retrieve_topk_{name} scores", s, want_s)
        print(f"retrieve_topk_{name} (world size 1) vs retrieve_topk: "
              f"indices equal on {agree:.6f} of (query, rank) slots, "
              f"scores max_abs_err={err:.3g}")
        if agree < AGREE:
            raise SystemExit(f"retrieve_topk_{name}: agreement {agree}")
    return launches


# sharded training at world size 1: (backend, X layout) and epochs
SHARDED_RUNS = (("pallas", "sparse", 20), ("pallas", "dense", 20),
                ("xla", "dense", 4))


def sharded_launches_per_epoch(backend: str, x_format: str,
                               niter: int) -> dict:
    """Kernel launches of one sharded training epoch at world size 1: the
    train forward and backward, then the stopping-set eval forward.

    pallas: K1 on both parts of a step (the boundary part is empty at
    world size 1 but launched, as on every rank), forward and backward,
    and on the sparse fc1; the step planes one edge_masks launch (the
    empty boundary part draws nothing), X's planes another. xla: no K1;
    the K step masks one dropout_mask launch. Dense X adds its own
    dropout_mask launch beside the hidden layer's."""
    sparse = x_format == "sparse"
    per = {"dropout_mask": 1 + (not sparse)}
    if backend == "xla":
        per["dropout_mask"] += 1
        return per
    per.update(spmm_csr=2 * (2 * niter + sparse),
               spmm_csr_bwd=2 * niter + sparse, edge_masks=1 + sparse)
    return per


def sharded_training_path(dev, unsharded_ms: float):
    """Sharded training at world size 1 on NCCL (MS Academic, full
    width): ``train --propagation sharded`` on the pallas arm with sparse
    X (``ShardedSparseInput``) and with dense X, and on the xla arm with
    dense X; launch counts per epoch asserted, a finite and falling loss,
    host ms per epoch beside the unsharded pallas epoch of phase 5
    (``unsharded_ms``), and one epoch on the card against the same epoch
    on the CPU (a gloo group of its own). Returns launch counts per
    path."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.kernels import build

    launches = {}
    for b, xf, epochs in SHARDED_RUNS:
        ckpt = ROOT / "build" / "chip_smoke" / f"train_sharded_{b}_{xf}"
        metrics = ckpt.with_suffix(".jsonl")
        if metrics.exists():
            metrics.unlink()
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["train", "--dataset", DATASET, "--propagation",
                           "sharded", "--backend", b, "--x-format", xf,
                           "--device", str(dev), "--max-epochs",
                           str(epochs), "--patience", "100",
                           "--print-interval", "0", "--checkpoint-dir",
                           str(ckpt), "--metrics-out", str(metrics)])
        name = f"train sharded {b} {xf}"
        launches[name] = got = dict(build.LAUNCHES)
        if rc != 0:
            raise SystemExit(f"{name} exited {rc}")
        res = json.loads(buf.getvalue())
        rows = [json.loads(line) for line in metrics.read_text().splitlines()]
        rows = [r for r in rows if r["event"] == "epoch"]
        losses = [r["train_loss"] for r in rows]
        niter = res["config"]["niter"]
        per = sharded_launches_per_epoch(b, xf, niter)
        want = {k: per.get(k, 0) * epochs for k in got}
        if b == "pallas":   # the final evaluation
            want["spmm_csr"] += 2 * niter + (xf == "sparse")
        ts = np.array([r["ts"] for r in rows])
        ms = float(np.median(np.diff(ts[1:]))) * 1e3
        print(f"{name}: {len(rows)} epochs, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, valtest acc "
              f"{res['valtest']['accuracy']:.4f}, x_format "
              f"{res['x_format']}, ms/epoch (median of epochs 2..{epochs - 1}"
              f", host clock) {ms:.3f} against {unsharded_ms:.3f} unsharded "
              f"pallas (sparse X), launches per epoch {per}")
        if got != want or len(rows) != epochs or res["x_format"] != xf:
            raise SystemExit(f"{name}: {len(rows)} epochs, x_format "
                             f"{res['x_format']}, launches {got}, expected "
                             f"{want}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"{name}: loss not finite and falling: "
                             f"{losses}")
    for b, xf, _ in SHARDED_RUNS:
        sharded_epoch_card_vs_cpu(dev, b, xf)
    return launches


def sharded_epoch_card_vs_cpu(dev, backend: str, x_format: str,
                              x_dtype=None) -> None:
    """One sharded training epoch's loss and all-reduced weight gradients
    on the card (world size 1, NCCL) against the same epoch on the CPU
    (world size 1 on a gloo group of the same process), from the same key
    and weights. With bf16 X the loss is the NLL alone (no L2 term), so
    that the summed dW₁, rounded to bf16 after the all-reduce, is held
    equal or one bf16 ulp apart (``assert_bf16_ulp``)."""
    import torch.distributed as dist

    from ppnp_tpu_torch.builders import load_graph, resolve_alpha
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.parallel.mesh import Mesh, make_mesh
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import (default_idx_split_args,
                                      loss_and_grads, prepare_attr_input)

    cpu = torch.device("cpu")
    cfg = RunConfig(dataset=DATASET, propagation="sharded", backend=backend)
    graph = load_graph(cfg)
    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, default_idx_split_args)
    sg = build_sharded_graph(calc_A_hat(graph.adj_matrix), n_shards=1)
    key_init, key_epochs = prng.split(prng.PRNGKey(0))
    gloo = dist.new_group(ranks=[0], backend="gloo")
    meshes = (Mesh(group=gloo, rank=0, world_size=1, device=cpu),
              make_mesh(device=dev))
    out, raw = [], []
    for mesh in meshes:
        d = mesh.device
        csr = (build_sharded_csr(sg, shards=[0], device=d)[0]
               if backend == "pallas" else None)
        prop = ShardedPowerIteration(
            graph=sg, mesh=mesh, csr=csr, alpha=resolve_alpha(cfg),
            niter=cfg.niter, drop_prob=cfg.drop_prob, backend=backend)
        x = prepare_attr_input(graph, prop, x_format=x_format,
                               x_dtype=x_dtype)
        model = init_mlp_params(x.shape[1], [HIDDEN], int(labels.max()) + 1,
                                key=key_init, device=d)

        def epoch():
            return loss_and_grads(
                model, x, prop, torch.from_numpy(idx).to(d),
                torch.from_numpy(labels[idx]).long().to(d),
                key=prng.fold_in(key_epochs, 3), drop_prob=cfg.drop_prob,
                reg_lambda=0.0 if x_dtype else cfg.reg_lambda)

        loss, grads = epoch()
        if x_dtype:
            with unrounded():
                raw.append(epoch()[1][0].cpu())
        out.append((loss.item(), [g.cpu() for g in grads]))
    dist.destroy_process_group(gloo)
    (l_cpu, g_cpu), (l_card, g_card) = out
    err = [float((a - b).abs().max()) for a, b in zip(g_card, g_cpu)]
    dtype = f" in {x_dtype}" if x_dtype else ""
    print(f"one sharded epoch ({backend}, {x_format} X{dtype}) card vs CPU: "
          f"loss {l_card:.7f} vs {l_cpu:.7f}, grad max_abs_err {err}")
    np.testing.assert_allclose(l_card, l_cpu, rtol=RTOL, atol=ATOL)
    if x_dtype:
        apart = assert_bf16_ulp("sharded dW1", g_card[0], g_cpu[0],
                                raw=raw[::-1])
        print(f"  summed dW1 rounded to bf16: {apart} of "
              f"{g_cpu[0].numel()} entries one bf16 ulp apart")
        g_card, g_cpu = g_card[1:], g_cpu[1:]
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def hier_path(dev):
    """The hierarchical propagator at D = I = 1, built directly (one card
    holds one NCCL rank): its eval and train-mode outputs bit-equal to
    the flat world-size-1 arm's on the relabelled MS Academic graph (the
    xla arm under deterministic ``index_add_``), and the serving
    checkpoint's predictions through it (K K1 launches a request on
    pallas: only the interior part is present at 1 x 1), equal to the
    flat sharded ``predict``'s. Returns launch counts per path."""
    from ppnp_tpu_torch.builders import load_graph, resolve_alpha
    from ppnp_tpu_torch.checkpoint import restore_checkpoint
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.models.appnp import MLP
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.parallel.hier import (HierShardedPowerIteration,
                                              build_hier_csr,
                                              build_hier_sharded_graph)
    from ppnp_tpu_torch.parallel.mesh import make_hier_mesh, make_mesh
    from ppnp_tpu_torch.parallel.partition import (build_sharded_csr,
                                                   build_sharded_graph)
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration
    from ppnp_tpu_torch.train import get_predictions, prepare_attr_input

    ckpt = ROOT / "build" / "chip_smoke"
    cfg = RunConfig(dataset=DATASET, propagation="sharded")
    graph = load_graph(cfg)
    a_hat = calc_A_hat(graph.adj_matrix)
    n = graph.num_nodes()
    hg, sg = build_hier_sharded_graph(a_hat, 1, 1), build_sharded_graph(
        a_hat, 1)
    hmesh, mesh = make_hier_mesh(1, 1, device=dev), make_mesh(device=dev)
    model = MLP.from_state_dict(restore_checkpoint(str(ckpt))["best_state"],
                                device=dev)
    c = model.layers[-1].weight.shape[0]
    h = torch.from_numpy(np.random.RandomState(6).randn(
        sg.n_pad, c).astype(np.float32)).to(dev)
    key = prng.PRNGKey(9)
    kw = dict(alpha=resolve_alpha(cfg), niter=cfg.niter,
              drop_prob=cfg.drop_prob)
    launches = {}
    for b in ("xla", "pallas"):
        pallas = b == "pallas"
        hier = HierShardedPowerIteration(
            graph=hg, mesh=hmesh, backend=b, **kw,
            csr=build_hier_csr(hg, shards=[0], device=dev)[0]
            if pallas else None)
        flat = ShardedPowerIteration(
            graph=sg, mesh=mesh, backend=b, **kw,
            csr=build_sharded_csr(sg, shards=[0], device=dev)[0]
            if pallas else None)
        # index_add_ adds in no fixed order on the card unless asked to
        torch.use_deterministic_algorithms(not pallas)
        try:
            with torch.no_grad():
                same = [torch.equal(hier(h, train=train, key=key),
                                    flat(h, train=train, key=key))
                        for train in (False, True)]
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"hierarchical 1 x 1 ({b}) vs the flat world-size-1 arm: "
              f"eval {'bit-equal' if same[0] else 'DIFFERS'}, train "
              f"{'bit-equal' if same[1] else 'DIFFERS'}; parts present "
              f"{hier.present}")
        if not all(same):
            raise SystemExit(f"hierarchical 1 x 1 {b}: not bit-equal to "
                             "the flat arm")
        x = prepare_attr_input(graph, hier)
        build.reset_launches()
        for _ in range(REQUESTS):
            preds = get_predictions(model, x, hier)[:n]
        launches[f"predict hier {b}"] = got = dict(build.LAUNCHES)
        want = {k: 0 for k in got}
        if pallas:
            want["spmm_csr"] = cfg.niter * REQUESTS
        flat_preds = np.load(ckpt / f"preds_sharded_{b}.npz")["predictions"]
        print(f"predict hier {b} (1 x 1): launches {got}; predictions equal "
              f"to the flat sharded predict's on "
              f"{float((preds == flat_preds).mean()):.6f}")
        if got != want or not np.array_equal(preds, flat_preds):
            raise SystemExit(f"predict hier {b}: launches {got}, expected "
                             f"{want}, or predictions differ")
        del x
    hmesh.destroy()
    return launches


BF16_FLOPS = 989e12   # H100 SXM bf16 dense tensor-core peak (NVIDIA data sheet)
BF16_EPOCHS = {"pallas": 20, "fused": 20, "xla": 4}   # dense bf16 X
BF16_SWEEP_EPOCHS = 3    # batched sweep, G = 10, dense bf16 X
PROFILE_EPOCHS = 60      # two chunks of 50: the second one is traced
BF16_APART = 0.01        # dW1: at most this share one bf16 ulp apart


def assert_bf16_ulp(name: str, card: torch.Tensor, cpu: torch.Tensor,
                    raw=None) -> int:
    """``card`` and ``cpu`` are bf16 values held in f32 (a rounded dW),
    equal or one bf16 ulp apart beyond the difference of the unrounded
    f32 sums ``raw`` = (card's, CPU's), which are held within rtol 1e-4 /
    atol 1e-5 (summation order; where the sum cancels, the order moves
    it by more than a bf16 ulp of the result), and at most BF16_APART of
    them apart; returns the count apart."""
    card, cpu = card.cpu(), cpu.cpu()
    for t in (card, cpu):
        if not torch.equal(t, t.bfloat16().float()):
            raise SystemExit(f"{name}: not rounded to bf16")
    slack = 0.0
    if raw is not None:
        u_card, u_cpu = raw[0].cpu(), raw[1].cpu()
        torch.testing.assert_close(u_card, u_cpu, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        slack = (u_card - u_cpu).abs()
    apart = card != cpu
    ulp = torch.maximum(card.abs(), cpu.abs()) * 2.0 ** -7 + slack
    if bool(((card - cpu).abs() > ulp)[apart].any()) \
            or float(apart.float().mean()) > BF16_APART:
        raise SystemExit(f"{name}: {int(apart.sum())} entries apart, some "
                         "by more than one bf16 ulp beyond the unrounded "
                         f"difference, or more than {BF16_APART} of them")
    return int(apart.sum())


@contextlib.contextmanager
def unrounded():
    """The mixed fc1's weight gradient left unrounded (``round_like`` the
    identity, where the backward and ``loss_and_grads`` read it): the f32
    sums that ``assert_bf16_ulp`` compares before the rounding."""
    from ppnp_tpu_torch import train
    from ppnp_tpu_torch.ops import mixed

    saved = mixed.round_like, train.round_like
    mixed.round_like = train.round_like = lambda dw, dtype: dw
    try:
        yield
    finally:
        mixed.round_like, train.round_like = saved


def bf16_launches_per_epoch(backend: str, niter: int) -> dict:
    """Kernel launches of one training epoch with dense X (either dtype):
    fc1 is a library product, so K1 runs only in the propagation (pallas:
    K forward, K backward, K in the stopping eval; fused: K3 and its
    adjoint); Â's K planes one edge_masks launch; X's dropout and the
    hidden layer's one dropout_mask launch each, and on the xla arm a
    third draws the K step masks."""
    per = {"dropout_mask": 2 + (backend == "xla")}
    if backend == "pallas":
        per.update(spmm_csr=2 * niter, spmm_csr_bwd=niter, edge_masks=1)
    elif backend == "fused":
        per.update(appnp_fused=2, appnp_adjoint=1, edge_masks=1)
    return per


DENSE_FINAL_EVAL = {"pallas": {"spmm_csr": 10}, "fused": {"appnp_fused": 1},
                    "xla": {}}


def run_train(dev, args, name: str, epochs: int):
    """``train`` in process, dense X, with the launch counts set to 0 just
    before and read just after, asserted per epoch; returns (launches,
    result, epoch rows, ms per epoch on the host clock)."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.kernels import build

    ckpt = ROOT / "build" / "chip_smoke" / name.replace(" ", "_")
    metrics = ckpt.with_suffix(".jsonl")
    if metrics.exists():
        metrics.unlink()
    backend = args[args.index("--backend") + 1]
    buf = io.StringIO()
    build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train", "--dataset", DATASET, "--x-format", "dense",
                       *args, "--device", str(dev), "--max-epochs",
                       str(epochs), "--patience", "1000", "--print-interval",
                       "0", "--checkpoint-dir", str(ckpt), "--metrics-out",
                       str(metrics)])
    got = dict(build.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"{name} exited {rc}")
    res = json.loads(buf.getvalue())
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    rows = [r for r in rows if r["event"] == "epoch"]
    losses = [r["train_loss"] for r in rows]
    per = bf16_launches_per_epoch(backend, res["config"]["niter"])
    want = {k: per.get(k, 0) * epochs
            + DENSE_FINAL_EVAL[backend].get(k, 0) for k in got}
    if got != want or len(rows) != epochs or res["x_format"] != "dense":
        raise SystemExit(f"{name}: {len(rows)} epochs, x_format "
                         f"{res['x_format']}, launches {got}, expected "
                         f"{want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"{name}: loss not finite and falling: {losses}")
    ms = float(np.median(np.diff([r["ts"] for r in rows][1:]))) * 1e3
    return got, res, rows, ms


def fc1_records(dev):
    """The bf16 fc1 and its neighbours at MS Academic's full width, each
    timed in device ms (``queued_ms``) beside its bound
    (max(bytes / HBM rate, operations / peak of their type)): the f32
    product (TF32 off) and the mixed bf16 one (bf16 operands, f32 sums:
    ``torch.mm(..., out_dtype=float32)``), each beside its plain
    version; dW as f32 product and as the port's backward (X upcast to
    f32, f32 product, rounded to bf16), with the bytes the upcast adds;
    dense dropout of X in f32 and in bf16. Holds the card against the
    CPU: forward within rtol 1e-5, dW equal or one bf16 ulp apart, bf16
    dropout bit-equal; and that the forward ran on bf16 operands with no
    f32 copy of X."""
    import types

    from torch.utils._python_dispatch import TorchDispatchMode

    from ppnp_tpu_torch.builders import load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.ops import mixed, prng
    from ppnp_tpu_torch.ops.dropout import dropout
    from ppnp_tpu_torch.train import prepare_attr_input

    graph = load_graph(RunConfig(dataset=DATASET))
    here = types.SimpleNamespace(device=dev)
    x32 = prepare_attr_input(graph, here, x_format="dense")
    x16 = prepare_attr_input(graph, here, x_format="dense",
                             x_dtype="bfloat16")
    n, f = x16.shape
    h = HIDDEN
    w = init_mlp_params(f, [h], 2, key=prng.PRNGKey(4),
                        device=dev).layers[0].weight.detach().t()
    g = torch.from_numpy(np.random.RandomState(5).randn(n, h).astype(
        np.float32) * 1e-4).to(dev)
    flops = 2.0 * n * f * h
    small = (f * h + n * h) * 4        # W in, the product out (f32)
    recs = {}

    def rec(name, fn, plain, bytes_moved, peak, err=None, **extra):
        b_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / peak) * 1e3
        by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / peak \
            else "operations"
        r = dict(ms=queued_ms(fn)[0], bound_ms=b_ms, bound_by=by,
                 plain_ms=None if plain is None else time_ms(plain),
                 max_abs_err=err, **extra)
        recs[name] = r
        print(f"{name}: " + " ".join(f"{k}={v}" for k, v in r.items()))

    with torch.no_grad():
        out16 = mixed.mixed_matmul(x16, w)
        ref16 = mixed.mixed_matmul(x16.cpu(), w.cpu())
        torch.cuda.synchronize()
        err = float((out16.cpu() - ref16).abs().max())
        torch.testing.assert_close(out16.cpu(), ref16, rtol=1e-5, atol=1e-7)

        class OpLog(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops = []

            def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                self.ops.append((str(func), [
                    (a.dtype, tuple(a.shape)) for a in args
                    if isinstance(a, torch.Tensor)], out.dtype,
                    tuple(out.shape)))
                return out

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with OpLog() as log:
            mixed.mixed_matmul(x16, w)
        torch.cuda.synchronize()
        extra_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        mm = [o for o in log.ops if o[0] == "aten.mm.dtype"]
        big_f32 = [o for o in log.ops if o[3] == (n, f)
                   and o[2] == torch.float32]
        print(f"fc1 bf16 forward ops on the card: {log.ops}; peak memory "
              f"above the inputs {extra_mb:.2f} MB")
        if len(mm) != 1 or mm[0][1] != [(torch.bfloat16, (n, f)),
                                        (torch.bfloat16, (f, h))] \
                or mm[0][2] != torch.float32 or big_f32 \
                or extra_mb > n * f * 4 / 2e6:
            raise SystemExit("fc1 bf16 forward did not run as one product "
                             "of bf16 operands into f32")
        rec("fc1 f32 (torch.mm, TF32 off)", lambda: torch.mm(x32, w), None,
            n * f * 4 + small, F32_FLOPS)
        rec("fc1 bf16 (mm out_dtype=f32)", lambda: mixed.mixed_matmul(x16, w),
            lambda: torch.matmul(x16.float(), w.bfloat16().float()),
            n * f * 2 + small, BF16_FLOPS, err)

        def backward(x, gr, round_dw=True):
            return mixed._MixedMatmul.backward(types.SimpleNamespace(
                saved_tensors=(x,), round_dw=round_dw), gr)[1]

        ctx = types.SimpleNamespace(saved_tensors=(x16,), round_dw=True)
        dw, dw_cpu = backward(x16, g), backward(x16.cpu(), g.cpu())
        apart = assert_bf16_ulp("fc1 bf16 dW", dw, dw_cpu, raw=(
            backward(x16, g, False), backward(x16.cpu(), g.cpu(), False)))
        print(f"fc1 bf16 dW card vs CPU: {apart} of {dw.numel()} entries one "
              "bf16 ulp apart, the rest equal")
        rec("dW f32 (Xᵀ·G, torch.mm)", lambda: torch.mm(x32.t(), g), None,
            n * f * 4 + small, F32_FLOPS)
        rec("dW bf16 (upcast, f32 mm, rounded)",
            lambda: mixed._MixedMatmul.backward(ctx, g), None,
            n * f * 2 + small, F32_FLOPS,
            float((dw.cpu() - dw_cpu).abs().max()),
            upcast_extra_bytes=8 * n * f,
            upcast_ms=time_ms(lambda: x16.float()))

        key = prng.PRNGKey(6)
        part = dropout(key, x16[:2048], 0.5)
        whole = dropout(key, x16, 0.5)
        cpu = dropout(key, x16[:2048].cpu(), 0.5)
        torch.cuda.synchronize()
        same = (torch.equal(part.cpu().view(torch.int16),
                            cpu.view(torch.int16))
                and torch.equal(whole[:2048], part)
                and whole.dtype == torch.bfloat16)
        print(f"dropout of bf16 X, rows [0, 2048) card vs CPU: "
              f"{'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise SystemExit("dropout of bf16 X: card and CPU differ")
        words = n * -(-f // 4)
        for name, x, size in (("dropout f32 X", x32, 4),
                              ("dropout bf16 X", x16, 2)):
            t_bytes = 2 * n * f * size / HBM_BYTES_PER_S
            lanes, imad = draw_ops(words, DRAW_BOTH)
            t_ops = max(lanes / INT32_OPS, (lanes + imad) / ISSUE_OPS)
            r = dict(ms=queued_ms(lambda: dropout(key, x, 0.5))[0],
                     bound_ms=max(t_bytes, t_ops) * 1e3,
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     plain_ms=None, max_abs_err=0.0)
            recs[name] = r
            print(f"{name}: " + " ".join(f"{k}={v}" for k, v in r.items()))
    return recs


def bf16_epoch_card_vs_cpu(dev) -> None:
    """One training epoch on bf16 X, pallas arm, on the card against the
    same epoch on the CPU from the same key and weights: the loss within
    1e-5, the NLL's dW₁ equal or one bf16 ulp apart, the other gradients
    within rtol 1e-4 / atol 1e-5."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import (init_mlp_params, l2_reg,
                                             ppnp_forward)
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.train import (_nll, default_idx_split_args,
                                      prepare_attr_input)

    cfg = RunConfig(dataset=DATASET, backend="pallas")
    graph = load_graph(cfg)
    labels = np.asarray(graph.labels)
    idx, _, _ = gen_splits(labels, default_idx_split_args)
    key_init, key_epochs = prng.split(prng.PRNGKey(0))
    out, raw = [], []
    for d in (torch.device("cpu"), dev):
        prop = build_propagator(cfg, graph, device=d)
        x = prepare_attr_input(graph, prop, x_format="dense",
                               x_dtype="bfloat16")
        model = init_mlp_params(x.shape[1], [HIDDEN], int(labels.max()) + 1,
                                key=key_init, device=d)

        def nll_grads():
            logp = ppnp_forward(model, x, prop, torch.from_numpy(idx).to(d),
                                key=prng.fold_in(key_epochs, 3), train=True)
            nll = _nll(logp, torch.from_numpy(labels[idx]).long().to(d))
            return nll, torch.autograd.grad(nll, list(model.parameters()))

        nll, grads = nll_grads()
        with unrounded():
            raw.append(nll_grads()[1][0])
        loss = nll + 5e-3 / 2.0 * l2_reg(model)
        out.append((loss.item(), [gr.cpu() for gr in grads]))
    (l_cpu, g_cpu), (l_card, g_card) = out
    apart = assert_bf16_ulp("one bf16 epoch dW1", g_card[0], g_cpu[0],
                            raw=raw[::-1])
    err = [float((a - b).abs().max()) for a, b in zip(g_card, g_cpu)]
    print(f"one epoch (pallas, dense bf16 X) card vs CPU: loss "
          f"{l_card:.7f} vs {l_cpu:.7f}; NLL dW1 {apart} of "
          f"{g_cpu[0].numel()} entries one bf16 ulp apart; grad "
          f"max_abs_err {err}")
    np.testing.assert_allclose(l_card, l_cpu, rtol=RTOL, atol=ATOL)
    for a, b in zip(g_card[1:], g_cpu[1:]):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def batched_epoch_card_vs_cpu(dev, dataset: str = "citeseer") -> None:
    """One batched epoch (G = 10 seeds, dense bf16 X, pallas arm) at
    Citeseer's size on the card against the CPU: per-seed losses within
    1e-5, each seed's dW₁ equal or one bf16 ulp apart, the other
    gradients within rtol 1e-4 / atol 1e-5."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.multiseed import _nll_g, grouped_forward
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.preprocessing import gen_splits
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS
    from ppnp_tpu_torch.train import (default_idx_split_args,
                                      prepare_attr_input)

    cfg = RunConfig(dataset=dataset, backend="pallas")
    graph = load_graph(cfg)
    labels = np.asarray(graph.labels)
    seeds = DEFAULT_SEEDS
    idx = np.stack([gen_splits(labels, dict(default_idx_split_args,
                                            seed=s & 0x7FFFFFFF))[0]
                    for s in seeds])
    keys = prng.fold_in(np.stack([prng.split(prng.PRNGKey(s))[1]
                                  for s in seeds]), 2)
    out, raw = [], []
    for d in (torch.device("cpu"), dev):
        prop = build_propagator(cfg, graph, device=d)
        x = prepare_attr_input(graph, prop, x_format="dense",
                               x_dtype="bfloat16")
        models = [init_mlp_params(x.shape[1], [HIDDEN],
                                  int(labels.max()) + 1,
                                  key=prng.split(prng.PRNGKey(s))[0],
                                  device="cpu") for s in seeds]
        params = [torch.stack([m.layers[i].weight.t() for m in models])
                  .detach().to(d).requires_grad_() for i in range(2)]

        def epoch():
            logp = grouped_forward(params, x, prop,
                                   torch.from_numpy(idx).to(d), keys,
                                   train=True, groups=len(seeds))
            loss = _nll_g(logp, torch.from_numpy(labels[idx]).long().to(d))
            return loss, torch.autograd.grad(loss.sum(), params)

        loss, grads = epoch()
        with unrounded():
            raw.append(epoch()[1][0].cpu())
        out.append((loss.detach().cpu(), [gr.cpu() for gr in grads]))
    (l_cpu, g_cpu), (l_card, g_card) = out
    apart = sum(assert_bf16_ulp(f"batched dW1 seed {s}", g_card[0][i],
                                g_cpu[0][i], raw=(raw[1][i], raw[0][i]))
                for i, s in enumerate(seeds))
    print(f"one batched epoch ({dataset}, G={len(seeds)}, dense bf16 X) card "
          f"vs CPU: losses max_abs_err "
          f"{float((l_card - l_cpu).abs().max()):.3g}; dW1 {apart} of "
          f"{g_cpu[0].numel()} entries one bf16 ulp apart")
    torch.testing.assert_close(l_card, l_cpu, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(g_card[1], g_cpu[1], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def trace_events(path):
    """The events of a Chrome-trace JSON written by ``profiling.trace``
    (it must parse)."""
    return json.loads(Path(path).read_text())["traceEvents"]


def kernel_events(events, kernel: str) -> int:
    return sum(1 for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", ""))


def tensorboard_scalars(logdir):
    """The scalars of a TensorBoard log dir by tag, (step, value) pairs;
    None where tensorboard cannot be imported."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
    except ImportError:
        return None
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def tracing_runs(dev, fused_request_ms):
    """``train --profile DIR --tensorboard DIR2`` over two chunks of 50
    epochs on the pallas and fused arms (dense bf16 X; the second chunk
    traced): each trace parses and holds the ``ppnp/*`` spans and its
    kernels (spmm_rows_kernel, appnp_fused_kernel), the kept K1 events
    counted against the launches of the traced epochs; the TensorBoard
    scalars equal the JSONL rows where tensorboard imports; then ``bench
    --training --profile``, the host µs of one ``annotate`` span with the
    profiler off and on, and the fused arm's request ms beside phase 4's.
    Returns launch counts per path."""
    from torch.profiler import ProfilerActivity, profile

    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.profiling import annotate, trace_path

    out_dir = ROOT / "build" / "chip_smoke"
    launches = {}
    importable = tensorboard_scalars(out_dir) is not None
    print(f"tensorboard importable: {importable}")
    traced = PROFILE_EPOCHS - 50
    for b, kernel in (("pallas", "spmm_rows_kernel"),
                      ("fused", "appnp_fused_kernel")):
        prof, tb = out_dir / f"profile_{b}", out_dir / f"tb_{b}"
        for d in (prof, tb):
            if d.exists():
                shutil.rmtree(d)
        name = f"train profile {b}"
        got, res, rows, ms = run_train(
            dev, ["--backend", b, "--x-dtype", "bfloat16", "--profile",
                  str(prof), "--tensorboard", str(tb)], name, PROFILE_EPOCHS)
        launches[name] = got
        events = trace_events(trace_path(prof))
        spans = {e.get("name") for e in events}
        per = bf16_launches_per_epoch(b, res["config"]["niter"])
        want = traced * (per.get("spmm_csr", 0) + per.get("spmm_csr_bwd", 0)
                         if b == "pallas" else per["appnp_fused"])
        kept = kernel_events(events, kernel)
        print(f"{name}: trace {len(events)} events, {kernel} events kept "
              f"{kept} of {want} launched in the {traced} traced epochs; "
              f"spans ppnp/mlp {'ppnp/mlp' in spans}, ppnp/propagate "
              f"{'ppnp/propagate' in spans}; ms/epoch {ms:.3f}")
        if not kept or not {"ppnp/mlp", "ppnp/propagate"} <= spans:
            raise SystemExit(f"{name}: the trace lacks {kernel} events or "
                             "the ppnp/* spans")
        scalars = tensorboard_scalars(tb)
        if importable:
            want_tb = {k: [(r["epoch"], float(np.float32(r[k])))
                           for r in rows]
                       for k in ("train_loss", "stopping_accuracy",
                                 "stopping_loss")}
            if scalars != want_tb:
                raise SystemExit(f"{name}: TensorBoard scalars differ from "
                                 "the JSONL rows")
            print(f"{name}: TensorBoard scalars equal the JSONL rows "
                  f"({len(rows)} epochs x 3 tags)")

    prof = out_dir / "profile_bench"
    if prof.exists():
        shutil.rmtree(prof)
    buf = io.StringIO()
    build.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["bench", "--training", "--dataset", DATASET,
                       "--backends", "pallas", "--x-format", "dense",
                       "--x-dtype", "bfloat16", "--epochs", "4",
                       "--profile", str(prof), "--device", str(dev)])
    launches["bench training profile"] = dict(build.LAUNCHES)
    res = json.loads(buf.getvalue())
    events = trace_events(trace_path(prof))
    kept = kernel_events(events, "spmm_rows_kernel")
    print(f"bench --training --profile: x_dtype {res['x_dtype']}, "
          f"{res['s_per_epoch'] * 1e3:.3f} ms/epoch under the profiler, "
          f"trace {len(events)} events, spmm_rows_kernel {kept}")
    if rc != 0 or res["x_dtype"] != "bfloat16" or not kept:
        raise SystemExit("bench --training --profile failed")

    def span_us(reps=20000):
        t0 = time.perf_counter()
        for _ in range(reps):
            with annotate("ppnp/mlp"):
                pass
        return (time.perf_counter() - t0) / reps * 1e6

    off = span_us()
    with profile(activities=[ProfilerActivity.CPU]):
        on = span_us()
    print(f"annotate span, host us: profiler off {off:.3f}, on {on:.3f}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["predict", "--dataset", DATASET, "--backend", "fused",
                       "--device", str(dev), "--checkpoint-dir", str(out_dir),
                       "--requests", str(REQUESTS)])
    now = json.loads(buf.getvalue())["request_ms"]
    print(f"predict --backend fused request_ms now {[round(t, 3) for t in now]}"
          f" beside phase 4's {[round(t, 3) for t in fused_request_ms]}")
    if rc != 0:
        raise SystemExit("predict fused exited non-zero")
    return launches


def bf16_path(dev, epoch_ms, fused_request_ms):
    """bf16 X and tracing, MS Academic at full width: the fc1 records;
    ``train --x-format dense --x-dtype bfloat16`` on every arm beside the
    dense f32 epoch and phase 5's sparse f32 one; one epoch card vs CPU;
    ``predict --x-dtype bfloat16`` of the trained checkpoint against the
    CPU port's and against f32 X; the batched bf16 sweep (G = 10) with
    its peak memory, and one batched epoch card vs CPU at Citeseer's
    size; a sharded bf16 epoch at world size 1 on NCCL card vs CPU; then
    the tracing runs. Returns (fc1 records, launch counts per path)."""
    from ppnp_tpu_torch.__main__ import main as cli_main
    from ppnp_tpu_torch.reproduce import DEFAULT_SEEDS

    recs = fc1_records(dev)
    launches, ms = {}, {}
    for b, epochs in BF16_EPOCHS.items():
        for dtype in ("bfloat16", "float32"):
            name = f"train dense {dtype} {b}"
            got, res, rows, ms[(b, dtype)] = run_train(
                dev, ["--backend", b, "--x-dtype", dtype], name, epochs)
            launches[name] = got
            print(f"{name}: {epochs} epochs, loss {rows[0]['train_loss']:.4f}"
                  f" -> {rows[-1]['train_loss']:.4f}, valtest acc "
                  f"{res['valtest']['accuracy']:.4f}, launches {got}")
        print(f"ms per epoch ({b}, host clock, median of epochs "
              f"2..{epochs - 1}): dense bf16 {ms[(b, 'bfloat16')]:.3f}, "
              f"dense f32 {ms[(b, 'float32')]:.3f}, sparse f32 (phase 5) "
              f"{epoch_ms[b]:.3f}")
    bf16_epoch_card_vs_cpu(dev)

    ckpt = ROOT / "build" / "chip_smoke" / "train_dense_bfloat16_pallas"
    preds = {}
    for d, dtype in ((dev, "bfloat16"), ("cpu", "bfloat16"),
                     (dev, "float32")):
        out_npz = ckpt.with_name(f"preds_dense_{dtype}_{d}.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["predict", "--dataset", DATASET, "--backend",
                           "pallas", "--x-format", "dense", "--x-dtype",
                           dtype, "--device", str(d), "--checkpoint-dir",
                           str(ckpt), "--out", str(out_npz)])
        if rc != 0:
            raise SystemExit(f"predict --x-dtype {dtype} on {d} exited {rc}")
        preds[(str(d), dtype)] = np.load(out_npz)["predictions"]
    card = preds[(str(dev), "bfloat16")]
    agree_cpu = float((card == preds[("cpu", "bfloat16")]).mean())
    agree_f32 = float((card == preds[(str(dev), "float32")]).mean())
    print(f"predict --x-dtype bfloat16 (pallas): argmax equal to the CPU "
          f"port's on {agree_cpu:.6f} of the nodes, to f32 X's (same "
          f"weights, card) on {agree_f32:.6f}")
    if agree_cpu < AGREE:
        raise SystemExit(f"bf16 predict: card vs CPU {agree_cpu} < {AGREE}")

    groups, niter = len(DEFAULT_SEEDS), 10
    torch.cuda.reset_peak_memory_stats()
    got, rows, wall, _ = run_reproduce(
        dev, ["--datasets", DATASET, "--backend", "pallas", "--x-format",
              "dense", "--x-dtype", "bfloat16", "--nseeds", str(groups),
              "--max-epochs", str(BF16_SWEEP_EPOCHS), "--patience", "100"],
        "sweep_bf16")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches["reproduce bf16 pallas"] = got
    per = {"spmm_grouped": niter, "spmm_grouped_bwd": niter,
           "spmm_csr": niter, "edge_masks": -(-groups * niter // 256),
           "dropout_mask": 2 * -(-groups // 256)}
    want = {k: per.get(k, 0) * BF16_SWEEP_EPOCHS
            + (niter if k == "spmm_csr" else 0) for k in got}
    loss = np.array([r["train_loss"] for r in rows])
    sweep_ms = float(np.median(np.diff([r["ts"] for r in rows]))) * 1e3
    print(f"reproduce pallas, dense bf16 X, G={groups}, "
          f"{BF16_SWEEP_EPOCHS} epochs: {wall:.2f} s, ms per batched epoch "
          f"(host clock) {sweep_ms:.3f}, peak memory "
          f"(max_memory_allocated) {peak_gb:.3f} GB, launches per epoch "
          f"{per}")
    if got != want or len(rows) != BF16_SWEEP_EPOCHS \
            or not np.isfinite(loss).all():
        raise SystemExit(f"reproduce bf16: {len(rows)} epochs, launches "
                         f"{got}, expected {want}, losses {loss}")
    batched_epoch_card_vs_cpu(dev)
    sharded_epoch_card_vs_cpu(dev, "pallas", "dense", "bfloat16")
    launches.update(tracing_runs(dev, fused_request_ms))
    return recs, launches


EXAMPLE_EPOCHS = 300    # the example's --max-epochs on each arm
EXAMPLE_TABLE = {"pallas": {"spmm_csr": 10}, "fused": {"appnp_fused": 1},
                 "xla": {}}   # the hidden table after training


def load_example():
    """``examples/simple_example_torch.py`` of this checkout, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "simple_example_torch", ROOT / "examples" / "simple_example_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def apart_ranks(scores: np.ndarray) -> np.ndarray:
    """The ranks of each query's top-k whose score differs from both its
    neighbours' by more than RTOL (the last rank: from the one before)."""
    gaps = -np.diff(scores, axis=1) > RTOL
    return (np.pad(gaps, ((0, 0), (1, 0)), constant_values=True)
            & np.pad(gaps, ((0, 0), (0, 1)), constant_values=True))


def public_surface_path(dev):
    """Phase 14: ``ops.spmm`` pallas against xla at phase 3's shapes (Â,
    c = 15), one K1 launch; the example's ``main`` on the xla, pallas and
    fused arms (launches per epoch, a falling loss, pallas and fused on
    the same stopping loss, each arm's top-5 equal to that of a float64
    table of its weights and pallas's weights giving the same top-5 on
    every arm where scores stand apart, ms per epoch and valtest
    accuracy); ``build_sparse_input`` on MS Academic's X
    against the ``SparseInput`` that ``train`` stages. Returns launch
    counts per path."""
    from ppnp_tpu_torch import load_dataset
    from ppnp_tpu_torch.builders import build_propagator
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.ops import (calc_A_hat, csr_from_scipy,
                                    csr_transpose, edge_list_from_scipy,
                                    prng, rcm_permutation, spmm)
    from ppnp_tpu_torch.ops.sparse_input import (SparseInput,
                                                 build_sparse_input)
    from ppnp_tpu_torch.preprocessing import normalize_attributes
    from ppnp_tpu_torch.retrieval import build_embedding_table, retrieve_topk
    from ppnp_tpu_torch.train import prepare_attr_input

    launches = {}
    graph = load_dataset(DATASET).standardize()
    a_hat = calc_A_hat(graph.adj_matrix)
    edges = edge_list_from_scipy(a_hat, device=dev)
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=dev)
    c = int(graph.labels.max()) + 1
    h = torch.from_numpy(np.random.RandomState(14).randn(
        a_hat.shape[0], c).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    build.reset_launches()
    got = spmm(edges, h, csr=csr, backend="pallas")
    torch.cuda.synchronize()
    launches["spmm pallas"] = dict(build.LAUNCHES)
    if launches["spmm pallas"] != {**dict.fromkeys(build.LAUNCHES, 0),
                                   "spmm_csr": 1}:
        raise SystemExit(f"spmm pallas: launches {launches['spmm pallas']}")
    err = compare("spmm pallas vs xla", got, spmm(edges, h))
    print(f"ops.spmm: pallas vs xla at n={a_hat.shape[0]} c={c}, max abs "
          f"err {err:.3g}, 1 K1 launch")

    example = load_example()
    runs = {}
    for b in ("xla", "pallas", "fused"):
        buf = io.StringIO()
        build.reset_launches()
        with contextlib.redirect_stdout(buf):
            out = example.main(["--device", str(dev), "--backend", b,
                                "--max-epochs", str(EXAMPLE_EPOCHS)])
        got = dict(build.LAUNCHES)
        launches[f"example {b}"] = got
        rows, res = out["epochs"], out["result"]
        epochs = len(rows)
        per = bf16_launches_per_epoch(b, 10)
        want = {k: per.get(k, 0) * epochs + DENSE_FINAL_EVAL[b].get(k, 0)
                + EXAMPLE_TABLE[b].get(k, 0) for k in got}
        losses = [r["train_loss"] for r in rows]
        if got != want or res["last_epoch"] != epochs - 1:
            raise SystemExit(f"example {b}: {epochs} epochs, launches {got}, "
                             f"expected {want}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise SystemExit(f"example {b}: loss not finite and falling")
        if not np.isfinite(out["scores"]).all():
            raise SystemExit(f"example {b}: non-finite top-5 scores")
        ms = float(np.median(np.diff([r["ts"] for r in rows][1:]))) * 1e3
        runs[b] = out
        print(f"example {b}: {epochs} epochs (best {res['best_epoch']}), "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, stopping loss "
              f"{rows[-1]['stopping_loss']!r}, valtest acc "
              f"{res['valtest']['accuracy']:.4f}, ms/epoch (median, host "
              f"clock) {ms:.3f}, top-5 of nodes 0-2 "
              f"{out['top5'].tolist()}, launches per epoch {per}")
    stop = {b: runs[b]["epochs"][-1]["stopping_loss"] for b in runs}
    if (len(runs["pallas"]["epochs"]) != len(runs["fused"]["epochs"])
            or abs(stop["pallas"] - stop["fused"]) > RTOL):
        raise SystemExit(f"example: pallas and fused stop apart: {stop}")
    print(f"example: pallas and fused final stopping loss bit-equal "
          f"{stop['pallas'] == stop['fused']} (difference "
          f"{abs(stop['pallas'] - stop['fused']):.3g})")
    def same_top5(what, top5, scores, ref_top5, ref_scores):
        apart = apart_ranks(scores) & apart_ranks(ref_scores)
        if not np.array_equal(top5[apart], ref_top5[apart]):
            raise SystemExit(f"example: top-5 of {what} differ: "
                             f"{top5.tolist()} vs {ref_top5.tolist()}")
        print(f"example: top-5 of {what} equal at {int(apart.sum())} of "
              f"{apart.size} ranks standing apart")

    # Each arm's top-5 is held against a float64 table of its own weights.
    # The arms train apart: xla draws its masks by slot, as the JAX
    # package's xla arm does; pallas and fused draw the same masks, but K3's
    # adjoint sums in another order than autograd over K1, so over hundreds
    # of epochs their weights part by ~1e-5 and early stopping may restore
    # another epoch. The retrieval on every arm is held on one set of
    # weights, pallas's, through each arm's propagator.
    cora = load_dataset("cora_ml").standardize()
    for b, out in runs.items():
        state = {k: v.cpu() for k, v in out["params"].state_dict().items()}
        table = reference_table(cora, state, 0.1, 10, "hidden")
        ref = torch.from_numpy(table[:3] @ table.T)
        ref_scores, ref_top5 = torch.topk(ref, 5, dim=1)
        same_top5(f"{b} and its float64 table", out["top5"], out["scores"],
                  ref_top5.numpy(), ref_scores.numpy())
    x = torch.from_numpy(np.asarray(normalize_attributes(
        cora.attr_matrix).todense(), dtype=np.float32)).to(dev)
    gen = torch.Generator().manual_seed(14)
    h0, up = (torch.randn(x.shape[0], HIDDEN, generator=gen).to(dev)
              for _ in range(2))
    tops, masked = {}, {}
    for b in runs:
        prop = build_propagator(RunConfig(dataset="cora_ml", backend=b),
                                cora, device=dev)
        table = build_embedding_table(runs["pallas"]["params"], x, prop,
                                      level="hidden")
        tops[b] = [t.cpu().numpy() for t in retrieve_topk(table[:3], table,
                                                          k=5)]
        # one masked propagation and its backward, for pallas against fused
        h = h0.clone().requires_grad_(True)
        y = prop.propagate(h, key=prng.PRNGKey(14), train=True)
        (y * up).sum().backward()
        masked[b] = (y.detach(), h.grad)
    for i, what in enumerate(("forward", "gradient")):
        a, b = masked["pallas"][i], masked["fused"][i]
        print(f"example: one masked propagation's {what}, pallas vs fused: "
              f"bit-equal {torch.equal(a, b)}, max abs diff "
              f"{float((a - b).abs().max()):.3g}, "
              f"{int((a != b).sum())} of {a.numel()} entries apart")
    if not np.array_equal(tops["pallas"][1], runs["pallas"]["top5"]):
        raise SystemExit("example: pallas's top-5 not reproduced")
    for b in ("xla", "fused"):
        same_top5(f"pallas's weights on pallas and {b}", tops["pallas"][1],
                  tops["pallas"][0], tops[b][1], tops[b][0])
    shared = {b: sum(len(set(p) & set(q)) for p, q in zip(
        runs[b]["top5"].tolist(), runs["pallas"]["top5"].tolist()))
        for b in ("xla", "fused")}
    print(f"example: best epochs "
          f"{ {b: r['result']['best_epoch'] for b, r in runs.items()} }; "
          f"of the 15 top-5 nodes of pallas's own weights, xla's share "
          f"{shared['xla']}, fused's {shared['fused']}")

    prop = build_propagator(RunConfig(dataset=DATASET, backend="pallas"),
                            graph, device=dev)
    staged = prepare_attr_input(graph, prop, x_format="sparse")
    attr = normalize_attributes(graph.attr_matrix)
    built = build_sparse_input(attr, device=dev)
    inline = csr_from_scipy(attr, device=dev)
    for name, ref in (("train's SparseInput", staged),
                      ("the CSR of X and its transpose",
                       SparseInput(csr=inline, csr_t=csr_transpose(inline)))):
        for part in ("csr", "csr_t"):
            m, r = getattr(built, part), getattr(ref, part)
            for field in ("row_ptr", "col", "val", "rows", "fwd_pos"):
                a, b = getattr(m, field), getattr(r, field)
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise SystemExit(f"build_sparse_input: {part}.{field} "
                                     f"differs from {name}")
    print(f"build_sparse_input: X {built.shape[0]}x{built.shape[1]} "
          f"nnz {built.csr.nnz}, X and X^T arrays equal to train's "
          "SparseInput and to the CSR of X and its transpose")
    return launches


# phase 15: scripts/blocked_train_torch.py at the JAX script's defaults
TRAIN_500K = 500_000       # nodes
TRAIN_500K_EPOCHS = 150    # max_epochs (patience 100)
TRAIN_500K_VALTEST = 0.95  # the task is near-separable
TRAIN_500K_CPU_BLOCKS = 4  # the card-vs-CPU epoch: 4 blocks of the same plan


def load_blocked_train():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "blocked_train_torch", ROOT / "scripts" / "blocked_train_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


LONG_SLEEP_CYCLES = 400_000_000   # ~0.2 s of GPU clock


def sequence_ms(fn, reps: int = 3) -> float:
    """Device ms of one ``fn()`` call whose launches are all enqueued
    behind one long sleep kernel (a call of hundreds of launches), median
    of ``reps``; raises where enqueueing outlasted the sleep."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        asleep, start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        asleep.record()
        torch.cuda._sleep(LONG_SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        fn()
        enqueue = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if enqueue > asleep.elapsed_time(start):
            raise SystemExit(f"sequence_ms: enqueueing took {enqueue:.1f} "
                             "ms, longer than the sleep")
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def propagation_device_ms(prop, c: int) -> None:
    """Device ms of the blocked propagation of a training epoch, each
    call's launches queued behind one long sleep: the eval forward
    (n_blocks·K K1 launches), the train forward (the same with the
    blocks' edge masks) and train forward + backward; ms per K1 launch
    beside one block's K1 repeated (inputs in L2) and after a write that
    evicts L2."""
    from ppnp_tpu_torch.kernels.spmm import spmm_csr
    from ppnp_tpu_torch.ops import prng

    bcsr, niter = prop.blocked, prop.niter
    h = torch.from_numpy(np.random.RandomState(16).randn(
        bcsr.n_rows, c).astype(np.float32)).to(prop.device)
    cot = torch.ones_like(h)
    key = prng.PRNGKey(16)

    def eval_fwd():
        with torch.no_grad():
            prop(h)

    def train_fwd():
        with torch.no_grad():
            prop(h, key=key, train=True)

    def train_fwd_bwd():
        hh = h.detach().requires_grad_()
        (prop(hh, key=key, train=True) * cot).sum().backward()

    # one block's K1, the same call repeated (its inputs stay in L2) and
    # after a 256 MB write between calls (L2 holds 50 MB)
    b, alpha = bcsr.n_blocks // 2, prop.alpha
    blk, lo, hw = bcsr.blocks[b], bcsr.col_lo[b], bcsr.hw
    hp = torch.zeros(bcsr.n_pad, c, device=prop.device)
    w = (1.0 - alpha) * blk.val
    wipe = torch.empty(64 * 2 ** 20, device=prop.device)
    warm = time_ms(lambda: spmm_csr(blk, hp[lo:lo + hw], w))
    wipe_ms = time_ms(lambda: wipe.fill_(1.0))
    cold = time_ms(lambda: (wipe.fill_(1.0),
                            spmm_csr(blk, hp[lo:lo + hw], w))) - wipe_ms
    print(f"K1 on block {b} at c = {c}: {warm:.5f} ms repeated (L2 warm), "
          f"{cold:.5f} ms after a 256 MB write ({wipe_ms:.5f} ms, "
          "subtracted)")
    del wipe
    # every block's K1 (repeated), beside its longest row
    per = []
    for blk, lo in zip(bcsr.blocks, bcsr.col_lo):
        w = (1.0 - alpha) * blk.val
        per.append((time_ms(lambda: spmm_csr(blk, hp[lo:lo + hw], w),
                            reps=5),
                    int((blk.row_ptr[1:] - blk.row_ptr[:-1]).max())))
    print(f"K1 per block at c = {c} (ms repeated, longest row): "
          + ", ".join(f"{i}: {t:.5f} ({m})" for i, (t, m) in enumerate(per))
          + f"; sum {sum(t for t, _ in per):.4f} ms a step")

    launches = bcsr.n_blocks * niter
    ms = {name: sequence_ms(fn) for name, fn in (
        ("eval", eval_fwd), ("train_fwd", train_fwd),
        ("train_fwd_bwd", train_fwd_bwd))}
    print(f"blocked propagation at 500k, device ms a call (launches queued "
          f"behind one sleep): eval {ms['eval']:.4f} ({launches} K1, "
          f"{ms['eval'] * 1e3 / launches:.3f} us each), train forward "
          f"{ms['train_fwd']:.4f} (+{bcsr.n_blocks} edge-mask launches), "
          f"train forward + backward {ms['train_fwd_bwd']:.4f} "
          f"(+{launches} K1 bwd)")


def blocked_train_path(dev):
    """Phase 15: ``scripts/blocked_train_torch.py``'s ``run`` in process
    at the JAX script's defaults (n = 500,000, nnz(Â) ≈ 10.5 M, 16
    classes, f = 512, hidden 64, K = 10, α = 0.1, 16,384 rows a block,
    150 epochs, patience 100): dense X, the launches per epoch, a finite
    and falling loss, valtest ≥ TRAIN_500K_VALTEST; one epoch card vs CPU
    on TRAIN_500K_CPU_BLOCKS blocks of the same generator; K1 forward and
    backward on one 500 k block at c = 16 and c = 64, and the dense
    dropout mask of the 500,000 × 512 X, each beside its plain version
    and bound. Returns (launch counts of the path, records to merge)."""
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.kernels.blocked import build_blocked_csr
    from ppnp_tpu_torch.kernels.masks import (dropout_masks,
                                              dropout_masks_plain)
    from ppnp_tpu_torch.metrics import JsonlWriter
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.dropout import quantized_keep
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
    from ppnp_tpu_torch.train import prepare_attr_input

    script = load_blocked_train()
    buf = io.StringIO()
    torch.cuda.synchronize()
    build.reset_launches()
    out, _, prop = script.run(TRAIN_500K, TRAIN_500K_EPOCHS, dev,
                              metrics=JsonlWriter(fileobj=buf))
    torch.cuda.synchronize()
    got = dict(build.LAUNCHES)
    print(json.dumps(out))
    bcsr, niter = prop.blocked, prop.niter
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    losses = [r["train_loss"] for r in rows if r["event"] == "epoch"]
    epochs = out["epochs_run"]
    per = blocked_launches_per_epoch(niter, bcsr.n_blocks, "dense")
    want = {k: per.get(k, 0) * epochs for k in got}
    want["spmm_csr"] += bcsr.n_blocks * niter   # the final evaluation
    print(f"blocked_train 500k: {bcsr.n_blocks} blocks of "
          f"{bcsr.rows_per_block} rows, window {bcsr.hw}, nnz {bcsr.nnz}; "
          f"gen {out['gen_s']:.3f} s, ingest {out['ingest_s']:.3f} s, "
          f"train {out['train_wall_s']:.3f} s, {epochs} epochs (best "
          f"{out['best_epoch']}), s/epoch (median) "
          f"{out['s_per_epoch_median']:.6f}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, valtest {out['valtest_accuracy']:.4f}, peak "
          f"memory {out['peak_mem_gb']:.3f} GB, launches per epoch {per}")
    if out["x_format"] != "dense" or out["n"] != TRAIN_500K:
        raise SystemExit(f"blocked_train 500k: x_format {out['x_format']} "
                         f"at n = {out['n']}, expected dense X")
    if got != want or len(losses) != epochs:
        raise SystemExit(f"blocked_train 500k: {len(losses)} epochs, "
                         f"launches {got}, expected {want}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise SystemExit(f"blocked_train 500k: loss not finite and "
                         f"falling: {losses}")
    if not out["valtest_accuracy"] >= TRAIN_500K_VALTEST:
        raise SystemExit(f"blocked_train 500k: valtest accuracy "
                         f"{out['valtest_accuracy']} < {TRAIN_500K_VALTEST}")

    # where an epoch's time goes, on the graph run() trained
    g = script.make_banded_classified(
        TRAIN_500K, n_edges=TRAIN_500K * script.EDGES_PER_NODE,
        bandwidth=script.BANDWIDTH, n_classes=script.N_CLASSES,
        n_features=script.N_FEATURES, nnz_per_row=script.NNZ_PER_ROW)
    profile_training_epochs("blocked_train 500k", g, prop,
                            prepare_attr_input(g, prop), reps=3)
    del g
    propagation_device_ms(prop, script.N_CLASSES)

    # one epoch card vs CPU on the first blocks' worth of the generator
    n_cpu = TRAIN_500K_CPU_BLOCKS * bcsr.rows_per_block
    g = script.make_banded_classified(
        n_cpu, n_edges=n_cpu * script.EDGES_PER_NODE,
        bandwidth=script.BANDWIDTH, n_classes=script.N_CLASSES,
        n_features=script.N_FEATURES, nnz_per_row=script.NNZ_PER_ROW)
    a_small = calc_A_hat(g.adj_matrix)

    def make_prop(d):
        return PPRPowerIteration(
            alpha=prop.alpha, niter=niter, drop_prob=prop.drop_prob,
            backend="blocked", blocked=build_blocked_csr(
                a_small, rows_per_block=bcsr.rows_per_block, reorder=None,
                device=d))
    one_epoch_card_vs_cpu(dev, f"blocked, n = {n_cpu}, dense X", g,
                          make_prop, "dense")

    # K1 on a middle block of the 500 k plan, its window as a row view
    b, r, alpha = bcsr.n_blocks // 2, bcsr.rows_per_block, prop.alpha
    blk, blk_t, lo = bcsr.blocks[b], bcsr.blocks_t[b], bcsr.col_lo[b]
    rng = np.random.RandomState(15)
    fwd, bwd = {}, {}
    for c in (script.N_CLASSES, HIDDEN):
        hp, gp = (torch.from_numpy(rng.randn(k, c).astype(np.float32)).to(
            dev) for k in (bcsr.hw, r))
        fwd[f"blocked500k_c{c}"], bwd[f"blocked500k_c{c}"] = \
            operator_records(f"500k block {b} ({r} x {bcsr.hw}, c = {c})",
                             blk, blk_t, hp, alpha * gp, gp, 1.0 - alpha)
    print(f"500k block {b}: nnz {blk.nnz}, col_lo {lo}")

    # the dropout mask of the 500,000 x 512 X, one key
    _, thresh = quantized_keep(prop.drop_prob)
    shape = (out["n"], out["n_features"])
    keys = prng.split(prng.fold_in(prng.PRNGKey(0), 88), 1)
    words = shape[0] * -(-shape[1] // 4)
    mask = record(
        f"dropout mask (dense X, {shape[0]} x {shape[1]}, 1 key)",
        lambda: (dropout_masks(keys, shape, thresh, dev),),
        lambda: (dropout_masks_plain(keys, shape, thresh, dev),), None,
        shape[0] * shape[1], 0,
        exact_ref=(dropout_masks_plain(keys, shape, thresh),),
        int_ops=draw_ops(words, DRAW_BOTH))
    return ({"blocked_train 500k": got},
            {"spmm_csr": fwd, "spmm_csr_bwd": bwd,
             "dropout_mask": {"x_dense_500k": mask}})


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
    fwd, bwd = block_and_shard_records(dev)
    for name, extra in (("spmm_csr", fwd), ("spmm_csr_bwd", bwd)):
        recs[name].update(extra, max_abs_err=max(
            [recs[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in extra.values()]))
    if not_exact:
        raise SystemExit(f"not bit-equal to the K1 chain: {not_exact}")
    if "--kernels-only" in sys.argv[1:]:
        # phase 3 alone, to compare the kernels of two checkouts on one
        # card; no result line
        print(json.dumps({"kernel_records": recs}))
        return 0
    k3_launch_report(dev)
    served, request_ms = serving_path(dev)
    launches = {f"predict {b}": v for b, v in served.items()}
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
    t0 = time.perf_counter()
    launches.update(blocked_path(dev))
    print(f"blocked phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches.update(sharded_path(dev))
    print(f"sharded phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches.update(sharded_training_path(dev, epoch_ms["pallas"]))
    launches.update(hier_path(dev))
    print(f"sharded training and hierarchical phase: "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fc1_recs, bf16_launches = bf16_path(dev, epoch_ms, request_ms["fused"])
    launches.update(bf16_launches)
    torch.distributed.destroy_process_group()
    print(f"bf16 X and tracing phase: {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"library_products": fc1_recs}))
    t0 = time.perf_counter()
    launches.update(public_surface_path(dev))
    print(f"public surface and example phase: "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_500k, extra = blocked_train_path(dev)
    launches.update(train_500k)
    for name, more in extra.items():
        recs[name].update(more, max_abs_err=max(
            [recs[name]["max_abs_err"]]
            + [r["max_abs_err"] for r in more.values()]))
    print(f"training at 500k nodes phase: "
          f"{time.perf_counter() - t0:.2f} s")

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
