"""Run one cell of the benchmark of ``ppnp_tpu_torch`` and print its line.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. It builds the kernels it lacks (into the checkout's
``build/ppnp_tpu_torch/``), makes the graph and the seeds, runs the
cell's entry of the program (set-up, then a window of ``--seconds``;
with ``--trace 1`` a profiled segment after it), checks what the timed
path produced against the plain reference, and prints one JSON line as
the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit, which also end standard error.

A cell on more than one card starts one process a card itself
(``ranks.launch``: this script again, with ``--rank``), relays their
standard error, and prints rank 0's line once every rank has ended;
when one rank fails, or the ranks pass ``DEADLINE_S``, it ends them all
and exits with 1.

It exits with 1 and prints no result when there is no CUDA card or
fewer than the cell asks for, when the program cannot be imported, or
when ``jax``, ``jaxlib``, ``flax`` or ``ppnp_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the launcher ends every rank past this (a run has 360 s)
DEADLINE_S = 350.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the launcher for each rank of a cell on several cards
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t-start", type=float, default=None,
                   help=argparse.SUPPRESS)
    # a benchmark tree other than this checkout's, and the ranks' device
    # (``cpu``: gloo), for the CPU tests of the four-rank mode
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    from portbench.spec import Bench
    bench = Bench(args.root or ROOT)
    chips = bench.cell(args.workload)["chips"]
    if chips > 1:
        return _launch(args, chips) if args.rank is None else _rank(
            args, bench, chips)

    import torch
    import ppnp_tpu_torch  # noqa: F401  (no result without the program)
    from portbench.harness import banned_modules, run_cell

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.set_num_threads(4)  # one process, few threads: steadier runs
    result, notes = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    banned = banned_modules()
    if banned:
        print(f"portbench: loaded {', '.join(banned)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 1
    for line in notes:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _launch(args, chips: int) -> int:
    """Start the cell's ranks, and print rank 0's result once all have
    ended with 0."""
    from portbench.ranks import launch
    from portbench.spec import banned_modules
    argv = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace),
            "--t-start", repr(T_START)]
    for opt in ("root", "device"):
        if getattr(args, opt) is not None:
            argv += [f"--{opt}", getattr(args, opt)]
    rc, lines = launch(Path(__file__), argv, chips, deadline_s=DEADLINE_S)
    if rc or not lines or banned_modules():
        return 1
    out = json.loads(lines[-1])
    for note in out["notes"]:
        print(note, file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


def _rank(args, bench, chips: int) -> int:
    """One rank: card ``--rank`` (or the CPU over gloo); rank 0 writes
    its result and its lines as one JSON line for the launcher."""
    import torch
    import ppnp_tpu_torch  # noqa: F401  (no result without the program)
    from portbench.harness import banned_modules, run_cell
    from portbench.ranks import Group

    device = args.device or f"cuda:{args.rank}"
    if device.startswith("cuda"):
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA cards; "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        torch.cuda.set_device(args.rank)
    torch.set_num_threads(4)
    result, notes = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=args.t_start,
                             device=device, group=Group(args.rank, chips))
    banned = banned_modules()
    if banned:
        print(f"portbench: loaded {', '.join(banned)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 1
    if args.rank:
        for line in notes:
            print(line, file=sys.stderr)
    else:
        print(json.dumps({"result": result, "notes": notes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
