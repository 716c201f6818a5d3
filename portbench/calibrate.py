"""The readings that a cell's limits are set from: the control and the
planted faults, at the cell's own size, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--program-seconds <s>]

For each seed it prints one JSON line with the numbers ``correct``
compares, as the control and each fault give them against the float64
reference, and with ``--program-seconds`` as a run of the program with
a window that long gives them (the limits' lower readings; a training
cell's numbers come from its first three steps, whatever the window):

- training cells: ``control`` (the reference in TF32: every product's
  operands rounded to a 10-bit mantissa), ``half_batch`` (the mean of
  the loss over half of the training nodes) and ``unchanged`` (a step
  that leaves the weights as they were: no run needed, its change reads
  1 by the measure);
- serving cells: ``control`` (the classes TF32 puts first) and
  ``altered`` (one answer's class moved to the next index where it is
  produced).

The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(bench, workload: str, seed: int, device) -> dict:
    import torch
    from portbench import graphs, harness, reference
    from portbench.spec import kind_of
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = kind_of(traffic)
    groups = int(traffic.get("groups", 1))
    seeds = harness.cell_seeds(seed, groups)
    sample = harness.cell_sample(kind, traffic, seeds[3])
    raw = graphs.make_graph(cfg["graph"])
    prob = harness.reference_problem(raw, cfg, traffic, device)
    out = {"workload": workload, "seed": seed}
    if kind == "serve":
        m = cfg["model"]
        w1, w2 = harness.serving_weights(
            int(traffic["weight_sets"]), prob.f, max(m["hidden"]),
            prob.n_classes, seed, device)
        ctrl = alt = 0.0
        for k in range(w1.shape[0]):
            ref = reference.eval_logp(prob, w1[k], w2[k], alpha=m["alpha"],
                                      niter=m["niter"])
            low = reference.eval_logp(prob, w1[k], w2[k], alpha=m["alpha"],
                                      niter=m["niter"], precision="tf32")
            ctrl = max(ctrl, harness.serving_gap(ref, low.argmax(-1).cpu()))
            preds = ref.argmax(-1).cpu().numpy()
            preds[0] = (preds[0] + 1) % prob.n_classes
            alt = max(alt, harness.serving_gap(ref, preds))
        out.update(control={"gap": ctrl}, altered={"gap": alt})
        return out
    refs = harness.training_references(prob, cfg, kind, seeds, sample)

    def observed(runs):
        return [{"losses": r["losses"], "stop_losses": r["stop_losses"],
                 "grad1": r["grad1"],
                 "change": [p - q for p, q in zip(r["params"], r["params0"])]}
                for r in runs]

    for name, kw in (("control", {"precision": "tf32"}),
                     ("half_batch", {"fault": "half_batch"})):
        runs = harness.training_references(prob, cfg, kind, seeds, sample,
                                           **kw)
        out[name] = harness.compare_training(observed(runs), refs)
    still = [dict(o, change=[torch.zeros_like(c) for c in o["change"]])
             for o in observed(refs)]
    out["unchanged"] = harness.compare_training(still, refs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program-seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch
    from portbench.harness import run_cell
    from portbench.spec import Bench
    bench = Bench(ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(bench, args.workload, seed, torch.device(args.device))
        if args.program_seconds:
            run, _ = run_cell(bench, args.workload, seed, args.program_seconds,
                           False, t_start=time.perf_counter(),
                           device=args.device)
            r["program"] = {k: v["value"] for k, v in run["checks"].items()}
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
