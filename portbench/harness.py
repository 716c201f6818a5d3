"""One run of one cell: set-up, the measured window, the traced segment,
the per-layer readers and the comparison that decides ``correct``.

The entry a cell drives is the traffic file's ``entry``:

- ``train_model``: one ``train.train_model`` call on one seed;
- ``train_models``: one ``multiseed.train_models`` call on ``groups``
  seeds (the paper's protocol: each seed drives its split, its init and
  its dropout);
- ``get_predictions``: one client, each request one
  ``train.get_predictions`` over the whole graph, with the
  ``weight_sets`` served weight sets (drawn from the seed) in turn.

The configuration's ``model.propagation`` names the model the program
builds (``builders.build_propagator``): ``"power"``, APPNP's K steps
(the default), or ``"exact"``, PPNP's dense Π. Its ``"reference"``
names the module that ``correct`` is judged by (``Bench.reference``;
default ``portbench/reference.py``), which the harness calls only
through the loaded module.

A traffic file with ``"propagation": "sharded"`` builds the program's
row-sharded propagator (``builders.build_propagator``) over the cell's
``chips`` ranks, one process a card (``ranks.py``): every rank runs the
same call on its rows, rank 0 decides where the window ends and the
others end it at the same epoch boundary (``_RankWindow``), and rank 0
reads every rank's traced segment and runs the reference.

A training call is one object from set-up to the end: its first
``warmup`` epochs are set-up (the first three are the ones the reference
follows), the window runs from the epoch boundary after them to the
first boundary at or after ``seconds``, and the call is ended there by
the harness's ``metrics`` writer. Early stopping is set past anything a
window can hold (the configuration's ``patience``), so every epoch of
every run does the same work. An epoch boundary is a point where the
program has synchronised: it reads its epoch's scalars to the host
before it writes the row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from portbench import counts, graphs, rankreads
from portbench.spec import BANNED, Bench, banned_modules, kind_of
from portbench.tracing import Session, Trace

__all__ = ["run_cell", "Run", "WindowClosed", "BANNED", "banned_modules"]

_LEAD = 2  # traced boundaries before the read segment opens


class WindowClosed(Exception):
    """Raised at the boundary that ends the call."""


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the traced segment of ``units``
    epochs or requests, the cell's kind, its shapes, and the time of one
    unit over the measured window (profiler off); ``cfg`` and
    ``traffic``, the cell's configuration and mix as loaded from their
    files, from which a reader counts what the shapes do not give (split
    sizes, say); ``latencies_ms``, a serving window's requests (a failed
    one infinite). On several cards ``trace`` is rank 0's, ``traces``
    every rank's segment (the same epochs) and ``shards`` each rank's
    own shapes; ``shapes`` are the whole graph's."""
    kind: str
    trace: Trace
    units: int
    step_s: float
    shapes: counts.Shapes
    propagate_spans: tuple = ("ppnp/propagate", "ppnp/grouped_propagate")
    world: int = 1
    traces: tuple = ()
    shards: tuple = ()
    cfg: Dict = dataclasses.field(default_factory=dict)
    traffic: Dict = dataclasses.field(default_factory=dict)
    latencies_ms: tuple = ()


class _Window:
    """The ``metrics`` writer handed to a training call: stamps every
    epoch boundary, opens the window after ``warmup`` epochs, closes it
    at the first boundary at or after ``seconds``, then traces
    ``trace_units`` epochs (after ``_LEAD``) or ends the call."""

    def __init__(self, warmup: int, seconds: float, trace_units: int,
                 capture: Callable[[int, Dict], None]):
        self.warmup, self.seconds = warmup, seconds
        self.trace_units, self.capture = trace_units, capture
        self.phase = "warmup"
        self.stamps: List[float] = []
        self.session: Optional[Session] = None
        self._left = 0

    def write(self, event: str, **row) -> None:
        if event != "epoch":
            return
        now = time.perf_counter()
        self.capture(int(row["epoch"]), row)
        if self.phase == "warmup":
            if row["epoch"] + 1 >= self.warmup:
                self.stamps = [now]
                self.phase = "window"
        elif self.phase == "window":
            self.stamps.append(now)
            if self._closes(int(row["epoch"]), now):
                if not self.trace_units:
                    raise WindowClosed
                self.session = Session()
                self.phase, self._left = "lead", _LEAD
        else:
            self._left -= 1
            if self._left:
                return
            if self.phase == "lead":
                self.session.open_window()
                self.phase, self._left = "traced", self.trace_units
            else:
                self.session.close_window()
                raise WindowClosed

    def _closes(self, epoch: int, now: float) -> bool:
        """Whether the window closes at this boundary."""
        return now - self.stamps[0] >= self.seconds

    @property
    def t0(self) -> float:
        return self.stamps[0]


class _RankWindow(_Window):
    """The window of one rank of several: rank 0, at its first boundary
    at or after ``seconds``, publishes the next epoch as the last one
    (under ``Group.window_key``), and every rank closes at that epoch's
    boundary. Each epoch holds collectives over every rank, so no rank
    can end epoch e + 1 before rank 0 has ended epoch e and published:
    a rank reads the store at its boundaries, never the device."""

    def __init__(self, *args, group):
        super().__init__(*args)
        self.group, self.key = group, group.window_key()
        self.stop: Optional[int] = None

    def _closes(self, epoch: int, now: float) -> bool:
        store = self.group.store
        if self.stop is None:
            if self.group.rank == 0 and super()._closes(epoch, now):
                self.stop = epoch + 1
                store.set(self.key, str(self.stop))
            elif self.group.rank and store.check([self.key]):
                self.stop = int(store.get(self.key))
        if self.stop is not None and epoch > self.stop:
            raise RuntimeError(f"rank {self.group.rank} passed the window's "
                               f"last epoch {self.stop}")
        return epoch == self.stop


@contextlib.contextmanager
def _observe(module, holder: Dict, select: Callable):
    """Hand the optimizer a training call makes, and a copy of its
    weights before the first step, to ``holder``: ``module.Adam`` is
    replaced by a subclass for the call (the arithmetic is Adam's)."""
    base = module.Adam

    class Observed(base):
        def __init__(self, params, *args, **kwargs):
            super().__init__(params, *args, **kwargs)
            holder["opt"] = self
            holder["p0"] = [select(p).detach().clone() for p in self.params]

    module.Adam = Observed
    try:
        yield
    finally:
        module.Adam = base


def cell_seeds(seed: int, groups: int):
    """The cell's seeds, all drawn from ``--seed``: the model's key, the
    split's seed, ``groups`` distinct sweep seeds, and a generator for
    the rest (the samples the reference follows)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed % 2 ** 128))
    model_seed = int(rng.integers(0, 2 ** 32))
    split_seed = int(rng.integers(0, 2 ** 31))
    sweep = [int(s) for s in rng.choice(2 ** 32, size=groups, replace=False)]
    return model_seed, split_seed, sweep, rng


def cell_sample(kind: str, traffic: Dict, rng) -> List[int]:
    """The models the reference follows: the one model, or a sample of
    ``sample_seeds`` of a sweep's seeds drawn from the cell's seed."""
    if kind != "sweep":
        return [0]
    groups = int(traffic["groups"])
    return sorted(rng.choice(groups, size=min(groups,
                                              traffic["sample_seeds"]),
                             replace=False).tolist())


def _program_inputs(raw: graphs.RawGraph, cfg: Dict, traffic: Dict, dev):
    """The program's graph, propagator and staged X, built by its own
    entry points from copies of the raw graph: the propagation the
    configuration's model names (``"exact"`` on one card only, with no
    backend), row-sharded where the mix says so."""
    from ppnp_tpu_torch.builders import build_propagator
    from ppnp_tpu_torch.config import RunConfig
    from ppnp_tpu_torch.data.sparsegraph import SparseGraph
    from ppnp_tpu_torch.kernels.blocked import build_blocked_csr
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
    from ppnp_tpu_torch.train import prepare_attr_input

    graph = SparseGraph(adj_matrix=raw.adj.copy(), attr_matrix=raw.attr.copy(),
                        labels=raw.labels.copy())
    if cfg["standardize"]:
        graph = graph.standardize()
    m = cfg["model"]
    propagation = m.get("propagation", "power")
    if propagation == "exact" and (traffic.get("propagation") == "sharded"
                                   or "backend" in traffic):
        raise ValueError("an exact model runs on one card: its mix names "
                         "neither a sharded propagation nor a backend")
    if traffic.get("propagation") == "sharded":
        # the graph in its own order: the CLI's --shard-reorder none
        prop = build_propagator(RunConfig(
            propagation="sharded", backend=traffic["backend"],
            exchange=traffic["exchange"], n_shards=traffic["n_shards"],
            alpha=m["alpha"], niter=m["niter"], drop_prob=m["drop_prob"]),
            graph, dev)
    elif traffic.get("backend") == "blocked":
        blocked = build_blocked_csr(
            calc_A_hat(graph.adj_matrix),
            rows_per_block=traffic["rows_per_block"],
            reorder=traffic.get("reorder"), with_adjoint=True, device=dev)
        prop = PPRPowerIteration(alpha=m["alpha"], niter=m["niter"],
                                 drop_prob=m["drop_prob"], backend="blocked",
                                 blocked=blocked)
    else:
        kw = dict(propagation=propagation, alpha=m["alpha"],
                  drop_prob=m["drop_prob"])
        if propagation == "power":
            kw.update(backend=traffic["backend"], niter=m["niter"])
        prop = build_propagator(RunConfig(**kw), graph, dev)
    x = prepare_attr_input(graph, prop, x_format=cfg["x_format"],
                           hidden=max(m["hidden"]))
    return graph, prop, x


def _train_kwargs(cfg: Dict, split_seed: int, window: _Window) -> Dict:
    m = cfg["model"]
    return dict(hidden_units=list(m["hidden"]), drop_prob=m["drop_prob"],
                learning_rate=m["learning_rate"], reg_lambda=m["reg_lambda"],
                idx_split_args=dict(cfg["split"], seed=split_seed),
                stopping_args={"max_epochs": cfg["max_epochs"],
                               "patience": cfg["patience"]},
                print_interval=0, metrics=window, x_format=cfg["x_format"])


def _drive_training(kind: str, cfg: Dict, traffic: Dict, graph, prop, x,
                    seeds, seconds: float, trace: bool, sample: List[int],
                    group=None):
    """Run the one training call; returns (window, observed numbers by
    model index in ``sample``)."""
    from ppnp_tpu_torch import multiseed, train
    model_seed, split_seed, sweep, _ = seeds
    holder: Dict[str, Any] = {"losses": [], "stop_losses": []}
    sel = (lambda p: p) if kind == "train" else (lambda p: p[sample])

    def picked(values):
        return [values] if kind == "train" else [values[g] for g in sample]

    def capture(epoch: int, row: Dict) -> None:
        if epoch >= 3:
            return
        holder["losses"].append(picked(row["train_loss"]))
        holder["stop_losses"].append(picked(row["stopping_loss"]))
        opt = holder["opt"]
        if epoch == 0:
            holder["grad1"] = [sel(mu).detach() / (1.0 - opt.b1)
                               for mu in opt.mu]
        if epoch == 2:
            holder["p3"] = [sel(p).detach().clone() for p in opt.params]

    warmup = int(traffic["warmup_epochs"])
    if warmup < 4:
        raise ValueError("warmup_epochs must cover the three steps that "
                         "the reference follows")
    args = (warmup, seconds, int(traffic["trace_epochs"]) if trace else 0,
            capture)
    window = (_Window(*args) if group is None
              else _RankWindow(*args, group=group))
    kw = _train_kwargs(cfg, split_seed, window)
    module = train if kind == "train" else multiseed
    with _observe(module, holder, sel):
        try:
            if kind == "train":
                train.train_model(graph, prop, seed=model_seed,
                                  x_prepared=x, **kw)
            else:
                multiseed.train_models(graph, prop, sweep, x_prepared=x,
                                       **kw)
        except WindowClosed:
            pass
    if window.phase == "warmup" or len(window.stamps) < 2:
        raise RuntimeError("the training call ended before its window")
    observed = []
    for j in range(len(holder["losses"][0])):
        # to the reference's layout (in, out): a Linear weight is (out,
        # in), the sweep stacks them transposed
        leaf = (lambda t: t.t()) if kind == "train" else (lambda t: t[j])
        observed.append({
            "losses": [step[j] for step in holder["losses"]],
            "stop_losses": [step[j] for step in holder["stop_losses"]],
            "grad1": [leaf(g).cpu() for g in holder["grad1"]],
            "change": [leaf(p3 - p0).cpu()
                       for p3, p0 in zip(holder["p3"], holder["p0"])]})
    holder.clear()
    return window, observed


def serving_weights(n_sets: int, f: int, hid: int, c: int, seed: int,
                    dev):
    """The served weight sets, Glorot-uniform, drawn on ``dev`` by a
    generator seeded with ``--seed``: (n_sets, f, hid), (n_sets, hid, c)
    in the layout ``x @ w``. More than one set gives the comparison more
    nodes whose classes lie near a tie, where a lower precision shows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    w1 = (torch.rand((n_sets, f, hid), generator=gen, device=dev) * 2 - 1) \
        * float(np.sqrt(6.0 / (f + hid)))
    w2 = (torch.rand((n_sets, hid, c), generator=gen, device=dev) * 2 - 1) \
        * float(np.sqrt(6.0 / (hid + c)))
    return w1, w2


def _drive_serving(cfg: Dict, traffic: Dict, graph, prop, x, seed: int,
                   rng, seconds: float, trace: bool, dev):
    """One client; returns (latencies s, window start and length, the
    sampled answers {weight set: (request, predictions)}, one request of
    each set drawn from the seed, the raw weights, failed, the traced
    segment or None). Request i is served with weight set i mod
    ``weight_sets``, each sent when the last has returned."""
    from ppnp_tpu_torch import train
    from ppnp_tpu_torch.models.appnp import MLP
    m = cfg["model"]
    f, hid = graph.attr_matrix.shape[1], max(m["hidden"])
    c = int(np.max(graph.labels)) + 1
    n_sets = int(traffic["weight_sets"])
    w1, w2 = serving_weights(n_sets, f, hid, c, seed, dev)
    models = []
    for k in range(n_sets):
        model = MLP([f, hid, c], device=dev)
        with torch.no_grad():
            model.layers[0].weight.copy_(w1[k].t())
            model.layers[1].weight.copy_(w2[k].t())
        models.append(model)
    sample: Dict[int, tuple] = {}
    served = [0] * n_sets
    failed, first_error = 0, None
    count = 0

    def request():
        nonlocal failed, first_error, count
        model = models[count % n_sets]
        count += 1
        try:
            return train.get_predictions(model, x, prop)
        except Exception as exc:  # a failed request is counted, not fatal
            failed += 1
            first_error = first_error or repr(exc)
            return None

    for _ in range(int(traffic["warmup_requests"])):
        request()
    lat: List[float] = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        preds = request()
        te = time.perf_counter()
        lat.append(te - ts if preds is not None else float("inf"))
        i, k = len(lat) - 1, (count - 1) % n_sets
        if preds is not None:
            served[k] += 1
            if rng.integers(0, served[k]) == 0:
                sample[k] = (i, preds)
        if te - t0 >= seconds:
            break
    span = te - t0
    traced = None
    if trace:
        session = Session()
        for _ in range(_LEAD):
            request()
        session.open_window()
        for _ in range(int(traffic["trace_requests"])):
            request()
        session.close_window()
        traced = session.finish()
    if first_error:
        print(f"first failed request: {first_error}", file=sys.stderr)
    return lat, t0, span, sample, (w1.cpu(), w2.cpu()), failed, traced


def _shapes(cfg: Dict, traffic: Dict, graph, prop, x, groups: int
            ) -> counts.Shapes:
    """The cell's shapes. Â's entries are read from the propagator's
    operator where it has one (its blocked or CSR form, the sharded
    plan), else counted from the graph (A + I), as for exact PPNP, whose
    Π has no sparse operator; an exact model has no K (``niter`` 0)."""
    m = cfg["model"]
    n, f = graph.attr_matrix.shape
    sparse = cfg["x_format"] == "sparse"
    if traffic.get("propagation") == "sharded":
        nnz = prop.graph.nnz  # the whole Â; x holds this rank's rows
        sparse_nnz = 0
    else:
        sparse_nnz = int(x.csr.nnz) if sparse else 0
        if getattr(prop, "blocked", None) is not None:
            nnz = prop.blocked.nnz
        elif getattr(prop, "csr", None) is not None:
            nnz = prop.csr.nnz
        else:
            nnz = (sp.csr_matrix(graph.adj_matrix)
                   + sp.identity(n, format="csr")).nnz
    return counts.Shapes(
        n=n, nnz=int(nnz), f=f, nnz_x=sparse_nnz,
        hidden=max(m["hidden"]), c=int(np.max(graph.labels)) + 1,
        niter=int(m.get("niter", 0)), x_sparse=sparse, groups=groups,
        propagation=m.get("propagation", "power"))


def _shard_shapes(shapes: counts.Shapes, prop) -> counts.Shapes:
    """This rank's own part of a row-sharded cell: its rows and the
    entries of its interior and boundary operators."""
    csr = prop.csr
    return dataclasses.replace(
        shapes, n=prop.graph.shard_rows,
        nnz=int(csr.interior.nnz + csr.boundary.nnz))


def _relative(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def compare_training(ref, observed, refs) -> Dict[str, float]:
    """The numbers ``correct`` compares in a training cell: each of the
    three steps' loss and the stopping-set loss after it (relative gap),
    the first gradient and the change after three steps (worst leaf, by
    the reference module ``ref``'s ``leaf_gaps``; the change over the
    entries whose first gradient is not near zero)."""
    loss = stop = grad = change = 0.0
    for obs, want in zip(observed, refs):
        loss = max(loss, _relative(obs["losses"], want["losses"]))
        stop = max(stop, _relative(obs["stop_losses"],
                                   want["stop_losses"]))
        grad = max(grad, max(ref.leaf_gaps(
            obs["grad1"], want["grad1"], want["grad1"])))
        change = max(change, max(ref.leaf_gaps(
            obs["change"], [p - q for p, q in zip(want["params"],
                                                   want["params0"])],
            want["grad1"], steady_entries=True)))
    return {"loss": float(loss), "stop_loss": float(stop),
            "grad": float(grad), "change": float(change)}


def serving_gap(logp_ref: torch.Tensor, preds) -> float:
    """The widest gap by which a served class's log-probability lies
    below the reference's best, over the nodes."""
    preds = torch.as_tensor(np.asarray(preds), dtype=torch.int64)
    best = logp_ref.max(dim=-1).values
    got = logp_ref.gather(1, preds[:, None].to(logp_ref.device))[:, 0]
    return float((best - got).max())


def training_references(ref, prob, cfg, kind, seeds, sample, *,
                        precision="float64", fault=None) -> List[Dict]:
    """The reference module ``ref``'s first three steps of each model in
    ``sample``."""
    model_seed, split_seed, sweep, _ = seeds
    out = []
    for g in sample:
        s = model_seed if kind == "train" else sweep[g]
        ss = split_seed if kind == "train" else s & 0x7FFFFFFF
        out.append(ref.train_steps(
            prob, cfg["model"], cfg["split"], seed=s, split_seed=ss,
            precision=precision, fault=fault))
    return out


def reference_problem(ref, raw, cfg, traffic, device):
    """The reference module ``ref``'s own derivation of the run's
    inputs from the raw graph (``prepare``)."""
    return ref.prepare(
        raw.adj, raw.attr, raw.labels, standardize=cfg["standardize"],
        arm=traffic.get("edge_ids"), x_format=cfg["x_format"],
        rows_per_block=traffic.get("rows_per_block", 0),
        reorder=traffic.get("reorder"),
        n_shards=traffic.get("n_shards", 0), device=device)


def _free_program(dev) -> None:
    """Let go of the program's state once its tensors are dropped: the
    process group (a sharded cell's), and the card's cached blocks."""
    import torch.distributed as dist
    gc.collect()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device=None, group=None):
    """One run; returns (the result line's object, the lines for
    standard error, which end with the numbers compared). ``t_start`` is
    the ``perf_counter`` reading at process start (at the launcher's
    start on several cards: ``perf_counter`` is CLOCK_MONOTONIC, one
    clock for every process of the machine). With ``group``
    (``ranks.Group``) this process is one rank of a sharded cell on
    ``device``; a rank other than 0 returns (None, its lines)."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    ref = bench.reference(cfg)
    kind = kind_of(traffic)
    if group is not None and kind != "train":
        raise ValueError(f"a {kind} cell runs on one card; only train_model "
                         "cells run over several ranks")
    dev = torch.device(device or "cuda")
    groups = int(traffic.get("groups", 1))
    seeds = cell_seeds(seed, groups)
    rng = seeds[3]
    sample = cell_sample(kind, traffic, rng)

    if dev.type == "cuda":
        from ppnp_tpu_torch.kernels import build
        build.build_kernels()
        torch.zeros(1, device=dev)
    t_graph = time.perf_counter()
    raw = graphs.make_graph(cfg["graph"], device=dev)
    if dev.type == "cuda":  # the peak is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t_inputs = time.perf_counter()
    graph, prop, x = _program_inputs(raw, cfg, traffic, dev)
    shapes = _shapes(cfg, traffic, graph, prop, x, groups)
    shard = _shard_shapes(shapes, prop) if group is not None else None
    stderr: List[str] = [
        f"set-up: {t_graph - t_start:.3f} s to the graph, graph "
        f"{t_inputs - t_graph:.3f} s, program inputs "
        f"{time.perf_counter() - t_inputs:.3f} s"]

    traced: Optional[Trace] = None
    latencies_ms: tuple = ()
    if kind in ("train", "sweep"):
        window, observed = _drive_training(kind, cfg, traffic, graph, prop,
                                           x, seeds, seconds, trace, sample,
                                           group)
        if window.session is not None:
            traced = window.session.finish()
        t0 = window.t0
        span = window.stamps[-1] - window.stamps[0]
        epochs = len(window.stamps) - 1
        per_epoch = np.diff(window.stamps) * 1e3
        unit_s = span / epochs
        e2e = {"epoch_ms": unit_s * 1e3,
               "seed_epochs_per_s": groups * epochs / span}
        attempted = epochs * groups
        failed = 0
        chunks = [per_epoch[i:i + 25].mean() for i in
                  range(0, len(per_epoch) - 24, 25)]
        stderr.append(
            f"epochs {epochs} in {span:.4f} s; ms an epoch: mean "
            f"{unit_s * 1e3:.4f}, median {np.median(per_epoch):.4f}, "
            f"p5 {np.percentile(per_epoch, 5):.4f}, p95 "
            f"{np.percentile(per_epoch, 95):.4f}; median of 25-epoch "
            f"chunks {np.median(chunks) if chunks else float('nan'):.4f}")
    else:
        lat, t0, span, answers, weights, failed, traced = _drive_serving(
            cfg, traffic, graph, prop, x, seed, rng, seconds, trace, dev)
        lat_ms = np.array(lat) * 1e3
        latencies_ms = tuple(lat_ms.tolist())
        finite = lat_ms[np.isfinite(lat_ms)]
        unit_s = span / len(lat)
        # closed loop, one client: the rate at which it completes
        # requests; its tail is read per layer (``request_p95_ms``)
        e2e = {"requests_per_s": (len(lat) - failed) / span}
        attempted = len(lat)
        stderr.append(
            f"requests {len(lat)} (failed {failed}) in {span:.4f} s, "
            f"{e2e['requests_per_s']:.4f} a second; "
            f"ms: p50 {np.percentile(lat_ms, 50):.4f}, p95 "
            f"{np.percentile(lat_ms, 95):.4f}, p99 "
            f"{np.percentile(lat_ms, 99):.4f}, mean "
            f"{finite.mean() if len(finite) else float('nan'):.4f}")
    e2e["setup_s"] = t0 - t_start

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    traces, shards, world = (traced,), (shard,), 1
    if group is not None:
        if group.rank:
            group.post({"trace": traced, "peak": int(peak), "shard": shard})
            del graph, prop, x
            _free_program(dev)
            group.freed()
            return None, stderr
        peers = group.collect()
        world = group.world
        peaks = [int(peak)] + [q["peak"] for q in peers]
        peak = max(peaks)
        traces += tuple(q["trace"] for q in peers)
        shards += tuple(q["shard"] for q in peers)
        stderr.append(f"memory peak by rank: {peaks}")
    result: Dict[str, Any] = {"correct": False, "attempted": attempted,
                              "failed": failed}
    if trace:
        run = Run(kind=kind, trace=traced, units=int(
            traffic["trace_epochs" if kind != "serve" else "trace_requests"]),
            step_s=unit_s, shapes=shapes, world=world, traces=traces,
            shards=shards, cfg=cfg, traffic=traffic,
            latencies_ms=latencies_ms)
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in bench.end_to_end(workload)}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": world, "memory_peak_bytes": int(peak)}
    if trace:
        stderr.append("card: " + _power_limit())
        busy = [t.busy_s() for t in traces]
        result["device"]["busy_s"] = float(np.mean(busy))
        result["device"]["window_s"] = traced.window_s
        pacing = rankreads.pacing(traces) or 0
        result["breakdown"] = traces[pacing].breakdown()
        if group is not None:
            stderr.append(
                f"breakdown of rank {pacing}, the pacing rank (busiest "
                "outside NCCL kernels); busy share by rank (outside NCCL "
                "kernels): " + ", ".join(
                    f"{b / t.window_s:.4f} "
                    f"({rankreads.without_nccl(t).busy_s() / t.window_s:.4f})"
                    for b, t in zip(busy, traces)))
            stderr += [f"rank {r}, device ms an epoch: " + "; ".join(
                f"{name[:48]} {1e3 * sec / run.units:.3f}"
                for name, sec in t.breakdown(top=8)["device_ops"])
                for r, t in enumerate(traces)]

    # the program's state goes before the reference runs
    del graph, prop, x
    _free_program(dev)
    if group is not None:
        group.wait_freed()
    t_ref = time.perf_counter()
    prob = reference_problem(ref, raw, cfg, traffic, dev)
    if kind == "serve":
        m = cfg["model"]
        checks = {"gap": max((serving_gap(ref.eval_logp(
            prob, weights[0][k], weights[1][k], alpha=m["alpha"],
            niter=m.get("niter")), preds)
            for k, (_, preds) in answers.items()), default=np.inf)}
    else:
        refs = training_references(ref, prob, cfg, kind, seeds, sample)
        checks = compare_training(ref, observed, refs)
    stderr.append(f"reference {time.perf_counter() - t_ref:.3f} s")
    result["correct"] = bool(
        failed == 0 and all(np.isfinite(v) and v <= limits[k]
                            for k, v in checks.items()))
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    stderr += [f"check {k}: {v!r} (limit {limits[k]!r})"
               for k, v in checks.items()]
    return result, stderr


def _power_limit() -> str:
    """The card's name and power limit, which the roofline and mfu
    shares are to be read beside (a card below 700 W runs slower)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"power limit not read ({exc!r})"
    return out.stdout.strip() or out.stderr.strip()

