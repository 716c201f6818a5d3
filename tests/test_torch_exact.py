"""Exact PPNP against the JAX package: Π, the propagation, and training.

Π = α(I − (1−α)Â)⁻¹ comes from LAPACK's solve through ``torch.linalg.solve``
in the port and from XLA's in the JAX package, so the two agree to f32
rounding of the factorization: within 1e-5 for Π (its entries are below
1 and the system is well conditioned, eigenvalues of M in [α, 2−α]). The
train-mode dropout on the selected Π rows is drawn from the same key in
both packages, bit for bit; products with H then differ only in f32
summation order.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppnp_tpu import builders as j_builders
from ppnp_tpu import train as j_train
from ppnp_tpu.config import RunConfig as JRunConfig
from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
from ppnp_tpu.ops.exact import PPRExact as JPPRExact
from ppnp_tpu.ops.exact import calc_ppr_exact as j_calc_ppr_exact
from ppnp_tpu.ops.normalize import calc_A_hat as j_calc_A_hat

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.metrics import JsonlWriter
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.exact import PPRExact, calc_ppr_exact
from ppnp_tpu_torch.ops.normalize import calc_A_hat

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


@pytest.fixture(scope="module")
def ppr_pair(small_graph, port_graph):
    """Π of small_graph at α = 0.1 from both packages (solve)."""
    want = np.asarray(j_calc_ppr_exact(j_calc_A_hat(small_graph.adj_matrix),
                                       0.1, method="solve"))
    got = calc_ppr_exact(calc_A_hat(port_graph.adj_matrix), 0.1,
                         method="solve", device="cpu")
    return want, got


@pytest.mark.parametrize("method", ["auto", "solve", "newton"])
def test_calc_ppr_exact_matches_jax(small_graph, port_graph, method):
    want = np.asarray(j_calc_ppr_exact(j_calc_A_hat(small_graph.adj_matrix),
                                       0.1, method=method))
    a_hat = calc_A_hat(port_graph.adj_matrix)
    got = calc_ppr_exact(a_hat, 0.1, method=method, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a dense Â gives the same Π
    dense = calc_ppr_exact(a_hat.toarray(), 0.1, method=method,
                           device="cpu")
    np.testing.assert_allclose(dense.numpy(), got.numpy(), **TOL)


def test_calc_ppr_exact_rejects_unknown_method(port_graph):
    with pytest.raises(ValueError, match="method"):
        calc_ppr_exact(calc_A_hat(port_graph.adj_matrix), 0.1,
                       method="inv", device="cpu")


def test_ppr_exact_eval_matches_jax(ppr_pair):
    want, got = ppr_pair
    jprop, prop = JPPRExact(ppr=jnp.asarray(want)), PPRExact(got)
    n = want.shape[0]
    rng = np.random.RandomState(0)
    h = rng.randn(n, 4).astype(np.float32)
    idx = rng.choice(n, 50, replace=False)
    np.testing.assert_allclose(
        prop(torch.from_numpy(h), torch.from_numpy(idx)).numpy(),
        np.asarray(jprop(jnp.asarray(h), jnp.asarray(idx))), **TOL)
    np.testing.assert_allclose(
        prop.propagate(torch.from_numpy(h)).numpy(),
        np.asarray(jprop.propagate(jnp.asarray(h))), **TOL)
    assert prop.device.type == "cpu"


def test_ppr_exact_train_masks_match_jax(ppr_pair):
    """Train mode drops entries of the selected Π rows with the JAX
    package's mask: the same zeros, and products within 1e-5."""
    want, got = ppr_pair
    jprop = JPPRExact(ppr=jnp.asarray(want), drop_prob=0.5)
    prop = PPRExact(got, drop_prob=0.5)
    n = want.shape[0]
    rng = np.random.RandomState(1)
    idx = rng.choice(n, 40, replace=False)
    key = prng.fold_in(prng.PRNGKey(3), 2)
    eye = np.eye(n, dtype=np.float32)   # H = I exposes dropout(Π[idx])
    jrows = np.asarray(jprop(jnp.asarray(eye), jnp.asarray(idx),
                             key=jnp.asarray(key), train=True))
    rows = prop(torch.from_numpy(eye), torch.from_numpy(idx), key=key,
                train=True).numpy()
    np.testing.assert_array_equal(rows == 0, jrows == 0)
    assert 0.4 < float((rows == 0).mean()) < 0.6
    np.testing.assert_allclose(rows, jrows, **TOL)


def _epoch_rows(text):
    rows = [json.loads(line) for line in text.splitlines()]
    return [r for r in rows if r["event"] == "epoch"]


def test_train_model_exact_matches_jax(small_graph, port_graph):
    """``train_model`` with exact PPNP on small_graph, 20 epochs, patience
    5: the same last and best epoch, per-epoch losses within 1e-6, the
    same stopping accuracies and valtest accuracy."""
    kw = dict(propagation="exact", max_epochs=20, patience=5, seed=3,
              print_interval=0, x_format="dense", ntrain_per_class=10,
              nstopping=60, nknown=200)
    jcfg, cfg = JRunConfig(**kw), RunConfig(**kw)
    jbuf, tbuf = io.StringIO(), io.StringIO()
    _, want = j_train.train_model(
        small_graph, j_builders.build_propagator(jcfg, small_graph),
        metrics=JJsonlWriter(fileobj=jbuf), epoch_chunk=10,
        **j_builders.train_kwargs(jcfg))
    prop = t_builders.build_propagator(cfg, port_graph, device="cpu")
    assert isinstance(prop, PPRExact)
    _, got = t_train.train_model(port_graph, prop,
                                 metrics=JsonlWriter(fileobj=tbuf),
                                 epoch_chunk=10, **t_builders.train_kwargs(cfg))
    assert (got["last_epoch"], got["best_epoch"]) == (want["last_epoch"],
                                                      want["best_epoch"])
    jrows, trows = _epoch_rows(jbuf.getvalue()), _epoch_rows(tbuf.getvalue())
    assert len(jrows) == len(trows) == want["last_epoch"] + 1
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose([r[name] for r in trows],
                                   [r[name] for r in jrows], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal([r["stopping_accuracy"] for r in trows],
                                  [r["stopping_accuracy"] for r in jrows])
    assert got["valtest"] == want["valtest"]
    assert set(want) <= set(got)
    assert not any(k.endswith("_gbps") for k in got)
