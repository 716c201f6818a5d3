"""One rank of a tiny four-rank cell with a fault planted underneath,
for the CPU tests of the four-rank mode:

    python3 portbench/tests/plant.py <fault> <run.py's arguments>

launches the cell's ranks as ``run.py`` does, each of them this script
with the fault (``ranks.launch`` adds ``--rank r``). Faults of the timed
path:
``unchanged`` (Adam leaves the weights), ``half_batch`` (the loss's mean
over half of the training nodes), ``rank0_key`` (rank 1's interior part
masked with rank 0's key), ``no_exchange`` (the received rows left
zero); faults of a rank: ``raise_setup`` (rank 1 raises while it builds
its inputs), ``raise_window`` (rank 2 raises at its first boundary of
the window); ``none`` plants nothing.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def plant(fault: str, rank: int) -> None:
    from portbench import harness
    from ppnp_tpu_torch import optim, train
    from ppnp_tpu_torch.kernels.masks import edge_masks
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.parallel.sharded import ShardedPowerIteration

    def fail(*args, **kwargs):
        raise RuntimeError(f"planted: {fault} on rank {rank}")

    if fault == "unchanged":
        optim.Adam.step = lambda self, grads, mask=None: None
    elif fault == "half_batch":
        nll = train._nll
        train._nll = lambda logp, y: nll(logp[: len(y) // 2], y[: len(y) // 2])
    elif fault == "rank0_key" and rank == 1:
        weights = ShardedPowerIteration.step_weights

        def rank0_interior(self, keys=None):
            planes = weights(self, keys)
            if keys is None:
                return planes
            csr = self.csr
            k0 = [prng.fold_in(prng.fold_in(k, 0), 0) for k in keys]
            return (edge_masks(k0, csr.interior, csr.interior_t,
                               keep=1.0 - self.drop_prob,
                               scale=1.0 - self.alpha), planes[1])

        ShardedPowerIteration.step_weights = rank0_interior
    elif fault == "no_exchange":
        exchange = ShardedPowerIteration._exchange
        ShardedPowerIteration._exchange = \
            lambda self, h: 0.0 * exchange(self, h)
    elif fault == "raise_setup" and rank == 1:
        harness._program_inputs = fail
    elif fault == "raise_window" and rank == 2:
        harness._RankWindow._closes = fail


if __name__ == "__main__":
    fault, argv = sys.argv[1], sys.argv[2:]
    from portbench import ranks, run
    if "--rank" in argv:
        plant(fault, int(argv[argv.index("--rank") + 1]))
    else:
        launch = ranks.launch
        ranks.launch = lambda script, args, world, **kw: launch(
            Path(__file__), [fault, *args], world, **kw)
    sys.exit(run.main(argv))
