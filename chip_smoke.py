#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ppnp_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, in
order; any failure exits non-zero and nothing is caught:

1. print the card's name and power limit (nvidia-smi); require CUDA and
   full-f32 matmuls (``allow_tf32`` False);
2. build every kernel from ``ppnp_tpu_torch/csrc`` (one nvcc per source,
   started together) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card at the
   MS Academic shapes of the main path, within rtol = atol = 1e-5 (only
   the f32 summation order differs), and time kernel, plain version and
   the nearest single PyTorch call (CUDA events, median of 25 launches);
4. drive the main path: write a checkpoint of random weights from a
   seeded generator, then run ``python -m ppnp_tpu_torch predict`` in
   process through the xla, pallas and fused backends, several requests
   each; assert the kernels' launch counts and that the backends agree;
5. print one ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero, printing no result, without a CUDA card or outside a
checkout (the package is imported from the checkout).
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
REQUESTS = 5           # forward passes per backend in the main path
RTOL = ATOL = 1e-5     # kernel vs plain version: f32 summation order only
AGREE = 0.999          # pallas / fused argmax equal to xla on ≥ this share
REF_TOL = 1e-4         # xla arm (f32) vs the float64 reference forward
SLEEP_CYCLES = 20_000_000   # ~10 ms of GPU clock: covers enqueueing 20 calls
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
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
    versions do) is timed with that wait."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def bound(bytes_moved: float, flops: float):
    """(least ms on the card, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise SystemExit(f"{name}: shape {tuple(out.shape)} vs "
                         f"{tuple(ref.shape)} or non-finite output")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    return err


def csr_tensor(a, values):
    return torch.sparse_csr_tensor(a.row_ptr, a.col, values,
                                   size=(a.n_rows, a.n_cols))


def kernel_phases(dev):
    """Phase 3: each kernel against its plain version at main-path
    shapes. Returns the per-kernel records (without launches)."""
    from ppnp_tpu_torch.builders import build_propagator, load_graph
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.kernels.fused import appnp_fused, appnp_fused_plain
    from ppnp_tpu_torch.kernels.spmm import spmm_csr, spmm_csr_plain
    from ppnp_tpu_torch.train import prepare_attr_input

    cfg = RunConfig(dataset=DATASET, backend="pallas")
    graph = load_graph(cfg)
    prop = build_propagator(cfg, graph, device=dev)
    a, alpha, niter = prop.csr, prop.alpha, prop.niter
    xin = prepare_attr_input(graph, prop, x_format="sparse")
    x = xin.csr
    n = a.n_rows
    c = int(graph.labels.max()) + 1
    f, hidden = x.n_cols, 64
    rng = np.random.RandomState(0)
    h = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dev)
    init = alpha * h
    w_fc1 = torch.from_numpy(
        (0.03 * rng.randn(f, hidden)).astype(np.float32)).to(dev)
    ws = prop.w_scaled
    print(f"shapes: n={n} nnz(A)={a.nnz} c={c} | X {n}x{f} "
          f"nnz(X)={x.nnz} hidden={hidden} | alpha={alpha} K={niter}")

    def record(name, kernel, plain, library, bytes_moved, flops):
        err = compare(name, kernel(), plain())
        b_ms, b_by = bound(bytes_moved, flops)
        rec = dict(max_abs_err=err, ms=time_ms(kernel),
                   plain_ms=time_ms(plain),
                   library_ms=None if library is None else time_ms(library),
                   bound_ms=b_ms, bound_by=b_by, call_ms=call_ms(kernel))
        print(f"{name}: max_abs_err={err:.3g} (tol rtol=atol={RTOL}) "
              + " ".join(f"{k}={v}" for k, v in rec.items()
                         if k != "max_abs_err"))
        return rec

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
    # K3: K steps in one launch, shared (1-α)Â plane; no single PyTorch
    # call computes K steps, so there is no library time
    planes = ws[None]
    k3 = record("K3", lambda: appnp_fused(a, h, alpha=alpha, niter=niter,
                                          e_w_all=planes),
                lambda: appnp_fused_plain(a, h, alpha=alpha, niter=niter,
                                          e_w_all=planes),
                None, (n + 1) * 4 + a.nnz * 8 + 2 * n * c * 4,
                niter * (2 * a.nnz * c + 2 * n * c))
    # one record per kernel: K1's headline numbers are at the propagation
    # step (10 of its 11 launches per pallas request); fc1 rides along
    k1 = dict(step, max_abs_err=max(step["max_abs_err"],
                                    fc1["max_abs_err"]), fc1=fc1)
    return {"spmm_csr": k1, "appnp_fused": k3}


def main_path(dev):
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
        want = {k: v * REQUESTS for k, v in expected[b].items()}
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
    return launches


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
    import scipy.sparse as sp
    attr = sp.csr_matrix(graph.attr_matrix, dtype=np.float64)
    rows = np.asarray(attr.sum(axis=1)).ravel()
    attr = sp.diags(np.where(rows > 0, 1.0 / np.maximum(rows, 1e-12), 0.0)) \
        @ attr
    w1 = state["layers.0.weight"].double().numpy()
    w2 = state["layers.1.weight"].double().numpy()
    h0 = np.maximum(attr @ w1.T, 0.0) @ w2.T
    adj = sp.csr_matrix(graph.adj_matrix, dtype=np.float64)
    adj = adj + sp.eye(adj.shape[0], format="csr")
    d = sp.diags(1.0 / np.sqrt(np.asarray(adj.sum(axis=1)).ravel()))
    a_hat = (d @ adj @ d).tocsr()
    h = h0
    for _ in range(niter):
        h = (1.0 - alpha) * (a_hat @ h) + alpha * h0
    h = h - h.max(axis=1, keepdims=True)
    return torch.from_numpy(h - np.log(np.exp(h).sum(axis=1,
                                                     keepdims=True)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # the port comes from the checkout this script sits in; without it
    # the import fails here, before anything is printed
    from ppnp_tpu_torch.kernels import build
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

    recs = kernel_phases(dev)
    launches = main_path(dev)

    meta = {
        "spmm_csr": dict(route="cuda", source="ppnp_tpu_torch/csrc/spmm.cu",
                         replaces="ppnp_tpu/kernels/spmm.py:71"),
        "appnp_fused": dict(route="cuda",
                            source="ppnp_tpu_torch/csrc/fused.cu",
                            replaces="ppnp_tpu/kernels/fused.py:84"),
    }
    kernels = []
    for name, rec in recs.items():
        total = sum(launches[b][name] for b in launches)
        if total == 0:
            raise SystemExit(f"{name} was never launched on the main path")
        kernels.append(dict(
            name=name, **meta[name], launches=total,
            launches_by_backend={b: launches[b][name] for b in launches},
            **rec))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
