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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    import ppnp_tpu_torch  # noqa: F401  (no result without the program)
    from portbench.harness import banned_modules, run_cell
    from portbench.spec import Bench

    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
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


if __name__ == "__main__":
    sys.exit(main())
