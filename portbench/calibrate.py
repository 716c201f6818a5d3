"""The readings that a cell's limits are set from: the control and the
planted faults, at the cell's own size, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--program-seconds <s>] [--fault-seeds <k>]

For each seed it prints one JSON line with the numbers ``correct``
compares, as the control and each fault give them against the float64
reference, and with ``--program-seconds`` as a run of the program with
a window that long gives them (the limits' lower readings; a training
cell's numbers come from its first three steps, whatever the window):

- training cells: ``control`` (the reference in TF32: every product's
  operands rounded to a 10-bit mantissa), ``half_batch`` (the mean of
  the loss over half of the training nodes) and ``unchanged`` (a step
  that leaves the weights as they were: no run needed, its change reads
  1 by the measure); on the sharded arm also ``rank0_key`` (rank 1's
  interior masked with rank 0's key) and ``no_exchange`` (the rows an
  exchange brings left out);
- serving cells: ``control`` (the classes TF32 puts first) and
  ``altered`` (one answer's class moved to the next index where it is
  produced).

A cell on several cards sets the program up once over its ranks
(``ranks.launch``), trains each seed in turn in that one set-up, and
each rank then works out the readings of every ``world``-th seed on its
own card; rank 0 prints them all. ``--fault-seeds k`` reads the control
and the faults on the first k seeds only (the program's on all).

It judges by the configuration's reference module (``Bench.reference``),
as a run does. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(bench, workload: str, seed: int, device, prob=None,
             faults: bool = True) -> dict:
    """The control's and the faults' numbers on one seed (``prob``: the
    reference's problem, made here when None); with ``faults`` False
    only the reference's own run (for ``program_readings``)."""
    import torch
    from portbench import graphs, harness
    from portbench.spec import kind_of
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    ref_mod = bench.reference(cfg)
    kind = kind_of(traffic)
    groups = int(traffic.get("groups", 1))
    seeds = harness.cell_seeds(seed, groups)
    sample = harness.cell_sample(kind, traffic, seeds[3])
    if prob is None:
        raw = graphs.make_graph(cfg["graph"], device=device)
        prob = harness.reference_problem(ref_mod, raw, cfg, traffic, device)
    out = {"workload": workload, "seed": seed}
    if kind == "serve":
        m = cfg["model"]
        w1, w2 = harness.serving_weights(
            int(traffic["weight_sets"]), prob.f, max(m["hidden"]),
            prob.n_classes, seed, device)
        ctrl = alt = 0.0
        for k in range(w1.shape[0]):
            ref = ref_mod.eval_logp(prob, w1[k], w2[k], alpha=m["alpha"],
                                    niter=m.get("niter"))
            low = ref_mod.eval_logp(prob, w1[k], w2[k], alpha=m["alpha"],
                                    niter=m.get("niter"), precision="tf32")
            ctrl = max(ctrl, harness.serving_gap(ref, low.argmax(-1).cpu()))
            preds = ref.argmax(-1).cpu().numpy()
            preds[0] = (preds[0] + 1) % prob.n_classes
            alt = max(alt, harness.serving_gap(ref, preds))
        out.update(control={"gap": ctrl}, altered={"gap": alt})
        return out
    refs = harness.training_references(ref_mod, prob, cfg, kind, seeds,
                                       sample)
    out["refs"] = refs
    if not faults:
        return out

    def observed(runs):
        return [{"losses": r["losses"], "stop_losses": r["stop_losses"],
                 "grad1": r["grad1"],
                 "change": [p - q for p, q in zip(r["params"], r["params0"])]}
                for r in runs]

    planted = [("control", {"precision": "tf32"}),
               ("half_batch", {"fault": "half_batch"})]
    if prob.n_shards > 1:
        planted += [("rank0_key", {"fault": "rank0_key"}),
                    ("no_exchange", {"fault": "no_exchange"})]
    for name, kw in planted:
        runs = harness.training_references(ref_mod, prob, cfg, kind, seeds,
                                           sample, **kw)
        out[name] = harness.compare_training(ref_mod, observed(runs), refs)
    still = [dict(o, change=[torch.zeros_like(c) for c in o["change"]])
             for o in observed(refs)]
    out["unchanged"] = harness.compare_training(ref_mod, still, refs)
    return out


def program_readings(bench, workload: str, seeds, seconds: float, device,
                     group, fault_seeds: int) -> list:
    """A cell on several cards: the program's numbers on each seed, all
    trained in one set-up, with the control's and the faults' on the
    first ``fault_seeds``; this rank's share of the seeds (every
    ``world``-th), worked out on its own card once the program's state
    is freed."""
    import torch
    from portbench import graphs, harness
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda":
        from ppnp_tpu_torch.kernels import build
        build.build_kernels()
    raw = graphs.make_graph(cfg["graph"], device=dev)
    graph, prop, x = harness._program_inputs(raw, cfg, traffic, dev)
    observed = {}
    for seed in seeds:
        s = harness.cell_seeds(seed, 1)
        _, observed[seed] = harness._drive_training(
            "train", cfg, traffic, graph, prop, x, s, seconds, False, [0],
            group)
    del graph, prop, x
    harness._free_program(dev)
    ref_mod = bench.reference(cfg)
    prob = harness.reference_problem(ref_mod, raw, cfg, traffic, dev)
    lines = []
    for i, seed in enumerate(seeds):
        if i % group.world != group.rank:
            continue
        r = readings(bench, workload, seed, dev, prob,
                     faults=i < fault_seeds)
        r["program"] = harness.compare_training(ref_mod, observed[seed],
                                                r.pop("refs"))
        lines.append(r)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program-seconds", type=float, default=0.0)
    p.add_argument("--fault-seeds", type=int, default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    from portbench.spec import Bench
    bench = Bench(args.root or ROOT)
    chips = bench.cell(args.workload)["chips"]
    fault_seeds = (len(args.seeds) if args.fault_seeds is None
                   else args.fault_seeds)
    if chips > 1:
        return _ranks(args, bench, chips, fault_seeds)
    import torch
    from portbench.harness import run_cell
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        r = readings(bench, args.workload, seed, torch.device(args.device),
                     faults=i < fault_seeds)
        r.pop("refs", None)
        if args.program_seconds:
            run, _ = run_cell(bench, args.workload, seed, args.program_seconds,
                           False, t_start=time.perf_counter(),
                           device=args.device)
            r["program"] = {k: v["value"] for k, v in run["checks"].items()}
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


def _ranks(args, bench, chips: int, fault_seeds: int) -> int:
    """Launch the ranks (no ``--rank``), or be one: rank 0 prints every
    rank's lines."""
    if args.rank is None:
        from portbench.ranks import launch
        argv = ["--workload", args.workload, "--device", args.device,
                "--program-seconds", repr(args.program_seconds),
                "--fault-seeds", str(fault_seeds), "--seeds",
                *map(str, args.seeds)]
        if args.root is not None:
            argv += ["--root", args.root]
        rc, lines = launch(Path(__file__), argv, chips, deadline_s=3500.0)
        print("".join(lines), end="", flush=True)
        return rc
    import torch
    from portbench.ranks import Group
    device = args.device
    if device == "cuda":
        torch.cuda.set_device(args.rank)
        device = f"cuda:{args.rank}"
    group = Group(args.rank, chips, timeout_s=3500.0)
    t = time.perf_counter()
    lines = program_readings(bench, args.workload, args.seeds,
                             args.program_seconds, device, group,
                             fault_seeds)
    for r in lines:
        r["seconds"] = time.perf_counter() - t
    if args.rank:
        group.post({"lines": lines})
        group.freed()
        return 0
    peers = group.collect()
    for r in lines + [r for q in peers for r in q["lines"]]:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
