"""The reference against the port at a small size, on the CPU: every
entry and arm of the harness runs end to end and comes out correct
under the real cells' limits; the frozen generators are the program's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import graphs, reference
from portbench.harness import run_cell
from portbench.tests import tinybench

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tinybench.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", sorted(tinybench.CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_correct_on_cpu(bench, workload, trace):
    r, _ = run_cell(bench, workload, SEED, 0.3, bool(trace), t_start=0.0,
                    device="cpu")
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    names = set(r["metrics"])
    if trace:
        assert {"device", "breakdown"} <= set(r)
        assert names <= {m["name"] for m in bench.per_layer(workload)}
        assert r["device"]["window_s"] > 0
    else:
        assert names == {m["name"] for m in bench.end_to_end(workload)}


def test_generators_are_the_programs():
    from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
    ours = graphs.attributed_sbm(500, 5, 200, 2000, intra_frac=0.75,
                                 words_per_node=8, topic_word_frac=0.2,
                                 seed=11)
    theirs = make_attributed_sbm(500, 5, 200, 2000, seed=11)
    assert (ours.adj != theirs.adj_matrix).nnz == 0
    assert (ours.attr != theirs.attr_matrix).nnz == 0
    assert np.array_equal(ours.labels, theirs.labels)

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "blocked_train_torch",
        tinybench.ROOT / "scripts" / "blocked_train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    g = mod.make_banded_classified(3000, 15000, 100, 4, 64, 5, seed=0)
    b = graphs.banded(3000, 4, 64, 15000, bandwidth=100, nnz_per_row=5,
                      seed=0)
    assert (b.adj != g.adj_matrix).nnz == 0
    assert (b.attr != g.attr_matrix).nnz == 0
    assert np.array_equal(b.labels, g.labels)
    # the same arrays, not only the same matrices: canonical CSR
    for ours, theirs in ((b.adj, g.adj_matrix), (b.attr, g.attr_matrix)):
        theirs = theirs.tocsr()
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(ours, field),
                                  getattr(theirs, field))


def test_reference_ids_and_init_are_the_programs():
    """The reference's own RCM ids, blocked ids and initial weights equal
    what the program builds from the same graph."""
    from ppnp_tpu_torch.kernels.blocked import build_blocked_csr
    from ppnp_tpu_torch.models.appnp import init_mlp_params
    from ppnp_tpu_torch.ops import prng
    from ppnp_tpu_torch.ops.normalize import calc_A_hat
    from ppnp_tpu_torch.ops.sparse import csr_from_scipy, rcm_permutation
    raw = graphs.banded(700, 4, 64, 3500, bandwidth=50, nnz_per_row=5,
                        seed=1)
    a = calc_A_hat(raw.adj)
    csr = csr_from_scipy(a, perm=rcm_permutation(a), device="cpu")
    p = reference.prepare(raw.adj, raw.attr, raw.labels, standardize=False,
                          arm="rcm", x_format="dense")
    perm = csr.perm.long()
    ours = sp.coo_matrix((p.a_ids.numpy().astype(np.float64), (
        p.a_rows.numpy(), p.a_cols.numpy())), shape=a.shape).tocsr()
    theirs = sp.coo_matrix((csr.edge_ids().numpy().astype(np.float64), (
        perm[csr.row_ids()].numpy(), perm[csr.col.long()].numpy())),
        shape=a.shape).tocsr()
    assert np.array_equal(ours.toarray(), theirs.toarray())

    bl = build_blocked_csr(a, rows_per_block=128, reorder=None,
                           device="cpu")
    q = reference.prepare(raw.adj, raw.attr, raw.labels, standardize=False,
                          arm="blocked", x_format="dense",
                          rows_per_block=128)
    for b, blk in enumerate(bl.blocks):
        sel = (q.a_block == b).numpy()
        got = sorted(q.a_ids.numpy()[sel].tolist())
        assert got == sorted(blk.edge_ids().tolist())

    key_init, _ = prng.split(prng.PRNGKey(SEED))
    model = init_mlp_params(64, [16], 4, key=key_init, device="cpu")
    k1, k2 = reference.split(reference.split(reference.prng_key(SEED))[0])
    assert torch.equal(reference.glorot_init(k1, 64, 16, "cpu"),
                       model.layers[0].weight.t())
    assert torch.equal(reference.glorot_init(k2, 16, 4, "cpu"),
                       model.layers[1].weight.t())


def test_edge_ids_of_an_arm_the_reference_does_not_derive():
    """A mix names the coordinates its arm keys edge masks by; one the
    reference does not derive (the xla arm's edge-list slots) is refused
    by name, not compared in the wrong coordinates."""
    raw = graphs.banded(300, 4, 16, 1500, bandwidth=20, nnz_per_row=5,
                        seed=2)
    with pytest.raises(ValueError, match="slots"):
        reference.prepare(raw.adj, raw.attr, raw.labels, standardize=False,
                          arm="slots", x_format="dense")


def test_change_leaves_out_entries_with_a_near_zero_gradient():
    """Adam steps a weight whose gradient is near zero by g / (|g| + eps),
    which rounding moves by up to its whole size: the change's steady
    reading leaves such entries out, by the reference's gradient alone."""
    grad = torch.full((40, 8), 1e-3, dtype=torch.float64)
    grad[3, 5] = 1e-9
    ref = torch.full((40, 8), 0.03, dtype=torch.float64)
    prog = ref.clone()
    prog[3, 5] = 0.0
    other = (torch.ones(8, 4, dtype=torch.float64),) * 3
    full = reference.leaf_gaps([prog, other[0]], [ref, other[1]],
                               [grad, other[2]])
    steady = reference.leaf_gaps([prog, other[0]], [ref, other[1]],
                                 [grad, other[2]], steady_entries=True)
    assert full[0] > 1e-4 and steady == [0.0, 0.0]
    prog[0, 0] = 0.0
    assert reference.leaf_gaps([prog, other[0]], [ref, other[1]],
                               [grad, other[2]], steady_entries=True)[0] \
        > 1e-4
