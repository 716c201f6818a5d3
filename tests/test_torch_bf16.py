"""bfloat16 attributes (``x_dtype=bfloat16``) against the JAX package.

Only a dense X is narrowed. The port stages ``bf16(f32 X)`` and draws the
dense dropout of it exactly as ``ppnp_tpu`` does (bit for bit, also at a
row offset); fc1 is ``X_bf16 · bf16(W₁)`` summed in f32
(``ops/mixed.py``), whose forward differs from JAX's only in f32
summation order (within 1e-6). Its weight gradient is
``f32(bf16(Xᵀ·G))`` on both sides: the unrounded products agree to f32
order, so after the rounding an entry is equal or one bf16 ulp apart
(relative up to 2⁻⁸ = 3.9e-3), and at most 1 % of the entries are apart.

Training: a one-ulp difference in an entry of dW₁ moves Adam's first
step of that entry by at most lr·2⁻⁸ (4e-5 at lr 0.01), which reaches the
loss damped by X's small L1-normed values; on ``small_graph`` the
per-epoch losses stay within 3.6e-7 of JAX's over 30 epochs, so they are
held within rtol = atol = 1e-4, the tolerance of the f32
``test_train_model_matches_jax``, and the stopping decisions, which is
what the protocol reports, exactly: the same best and last epoch, for
one seed and for G = 3 batched seeds.
"""

import io
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu import builders as j_builders
from ppnp_tpu import train as j_train
from ppnp_tpu.config import RunConfig as JRunConfig
from ppnp_tpu.metrics import JsonlWriter as JJsonlWriter
from ppnp_tpu.models.appnp import init_mlp_params as j_init_mlp_params
from ppnp_tpu.models.appnp import l2_reg as j_l2_reg
from ppnp_tpu.models.appnp import ppnp_forward as j_ppnp_forward
from ppnp_tpu.multiseed import train_models as j_train_models
from ppnp_tpu.ops.dropout import dropout as j_dropout
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import (pair_chunks_banded, slot_permutation,
                                     to_device, transpose_pair)
from ppnp_tpu.ops.propagation import PPRPowerIteration as JPPR
from ppnp_tpu.ops.sparse import edge_list_from_scipy
from ppnp_tpu.preprocessing import gen_splits

from ppnp_tpu_torch import builders as t_builders
from ppnp_tpu_torch import train as t_train
from ppnp_tpu_torch.__main__ import main as t_main
from ppnp_tpu_torch.config import RunConfig
from ppnp_tpu_torch.data.io import save_to_npz
from ppnp_tpu_torch.data.synthetic import make_attributed_sbm
from ppnp_tpu_torch.metrics import JsonlWriter
from ppnp_tpu_torch.models.appnp import params_from_jax, ppnp_forward
from ppnp_tpu_torch.multiseed import train_models
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import dropout, dropout_grouped
from ppnp_tpu_torch.ops.mixed import mixed_matmul
from ppnp_tpu_torch.ops.sparse_input import SparseInput

HIDDEN = [64]
NITER = 3
SPLIT = {"ntrain_per_class": 10, "nstopping": 60, "nknown": 200,
         "seed": 2413340114}
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=2,
           mids_per_step=1)
FWD_TOL = dict(rtol=1e-6, atol=1e-6)     # f32 summation order
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-4)   # module docstring
SEEDS = [2144199730, 794209841, 2985733717]


@pytest.fixture(scope="module")
def port_graph():
    """The port's own copy of the ``small_graph`` fixture."""
    return make_attributed_sbm(n_nodes=400, n_classes=4, n_features=128,
                               n_edges=1600, seed=7).standardize()


def _bits(x) -> np.ndarray:
    """The 16-bit patterns of a bf16 array of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def assert_bf16_ulp(got: np.ndarray, want: np.ndarray,
                    max_share: float = 0.01) -> None:
    """Both are bf16 values held in f32, equal or one bf16 ulp apart, and
    at most ``max_share`` of the entries apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for a in (got, want):
        assert np.array_equal(a, a.astype(jnp.bfloat16).astype(np.float32))
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    apart = got != want
    assert np.all(np.abs(got - want)[apart] <= ulp[apart])
    assert apart.mean() <= max_share


def _jax_prop(graph, backend):
    a_hat = calc_A_hat(graph.adj_matrix)
    pc = pc_t = w_perm = None
    if backend == "pallas":
        pc = pair_chunks_banded(a_hat, reorder="rcm", device=False,
                                use_native="never", **GEO)
        pc_t = transpose_pair(a_hat, perm=np.asarray(pc.perm),
                              device=False, use_native="never", **GEO)
        w_perm = jnp.asarray(slot_permutation(pc, pc_t))
        pc, pc_t = to_device(pc), to_device(pc_t)
    return JPPR(edges=edge_list_from_scipy(a_hat), pair_chunks=pc,
                pair_chunks_t=pc_t, w_perm=w_perm, alpha=0.1, niter=NITER,
                drop_prob=0.5, backend=backend)


def _port_prop(graph, backend):
    return t_builders.build_propagator(
        RunConfig(backend=backend, niter=NITER, alpha=0.1), graph,
        device="cpu")


@pytest.mark.parametrize("spelling", ["bfloat16", torch.bfloat16])
def test_staged_x_bit_equal(small_graph, port_graph, spelling):
    """``prepare_attr_input(x_dtype=bfloat16)`` stages the bits JAX
    stages (round to nearest even of the f32 L1-normed X)."""
    want = j_train.prepare_attr_input(small_graph, _jax_prop(small_graph,
                                                             "xla"),
                                      x_format="dense",
                                      x_dtype=jnp.bfloat16)
    x = t_train.prepare_attr_input(port_graph, _port_prop(port_graph, "xla"),
                                   x_format="dense", x_dtype=spelling)
    assert x.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(x), _bits(want))
    with pytest.raises(ValueError, match="x_dtype"):
        t_train.prepare_attr_input(port_graph, _port_prop(port_graph, "xla"),
                                   x_dtype="float16")


@pytest.mark.parametrize("rate", [0.5, 77 / 256])
@pytest.mark.parametrize("row_offset", [0, 37])
def test_bf16_dropout_bit_equal(rate, row_offset):
    """Dense dropout of a bf16 array: the same mask bits and the survivor
    scale ``x / keep`` computed in bf16, as JAX computes it; a rank's
    rows at ``row_offset`` are those rows of JAX's whole draw."""
    rng = np.random.RandomState(3)
    full = rng.rand(120, 37).astype(np.float32).astype(jnp.bfloat16)
    key = prng.PRNGKey(11)
    want = j_dropout(jnp.asarray(key), jnp.asarray(full), rate)
    rows = slice(row_offset, row_offset + 50)
    xt = torch.from_numpy(full.astype(np.float32)).to(torch.bfloat16)
    got = dropout(key, xt[rows], rate, row_offset=row_offset)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want)[rows])
    keys = prng.split(prng.PRNGKey(5), 3)
    grouped = dropout_grouped(keys, xt[rows], rate, shared=True,
                              row_offset=row_offset)
    assert grouped.dtype == torch.bfloat16
    for g in range(3):
        want_g = j_dropout(jnp.asarray(keys[g]), jnp.asarray(full), rate)
        np.testing.assert_array_equal(_bits(grouped[g]),
                                      _bits(want_g)[rows])


def _jax_fc1(x, w, g):
    """JAX's mixed fc1 (``appnp.py:82-84``): forward and the weight
    cotangent for output cotangent ``g``."""
    def fc1(wt):
        return jnp.matmul(x, wt.astype(x.dtype),
                          preferred_element_type=jnp.float32)
    out, vjp = jax.vjp(fc1, jnp.asarray(w))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("shape,density", [((400, 128), None),
                                           ((2000, 500), 0.05)])
def test_mixed_fc1_forward_and_dw(small_graph, shape, density):
    """fc1 on bf16 X within 1e-6 of JAX's, its dW equal or one bf16 ulp
    apart (≤ 1 % of entries); the batched form (one product per seed)
    holds the same against the 2-D one seed by seed (the batched product
    sums in another order), and ``round_dw=False`` leaves the f32 sum
    unrounded."""
    rng = np.random.RandomState(1)
    if density is None:
        x32 = j_train.prepare_attr_input(
            small_graph, _jax_prop(small_graph, "xla"), x_format="dense")
        x32 = np.asarray(x32)
    else:
        a = sp.random(*shape, density=density, random_state=rng,
                      format="csr", dtype=np.float32)
        x32 = np.asarray((sp.diags(1.0 / np.maximum(
            a.sum(1).A1, 1e-12)) @ a).todense(), np.float32)
    xb = jnp.asarray(x32, dtype=jnp.bfloat16)
    w = (rng.randn(shape[1], 64) * 0.1).astype(np.float32)
    g = (rng.randn(shape[0], 64) * 1e-3).astype(np.float32)
    want_out, want_dw = _jax_fc1(xb, w, g)

    xt = torch.from_numpy(x32.copy()).to(torch.bfloat16)
    wt = torch.from_numpy(w).requires_grad_()
    out = mixed_matmul(xt, wt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD_TOL)
    dw, = torch.autograd.grad(out, wt, torch.from_numpy(g))
    assert_bf16_ulp(dw.numpy(), want_dw)

    w3 = torch.from_numpy(np.stack([w, -w])).requires_grad_()
    g3 = torch.from_numpy(np.stack([g, 2 * g]))
    out3 = mixed_matmul(xt.expand(2, -1, -1), w3)
    dw3, = torch.autograd.grad(out3, w3, g3)
    for s in range(2):
        ws = w3[s].detach().clone().requires_grad_()
        os = mixed_matmul(xt, ws)
        torch.testing.assert_close(out3[s], os, **FWD_TOL)
        assert_bf16_ulp(dw3[s].numpy(),
                        torch.autograd.grad(os, ws, g3[s])[0].numpy())
    raw, = torch.autograd.grad(mixed_matmul(xt, wt, round_dw=False), wt,
                               torch.from_numpy(g))
    assert torch.equal(raw, xt.float().t() @ torch.from_numpy(g))
    with pytest.raises(ValueError, match="data"):
        mixed_matmul(xt.float().requires_grad_().bfloat16(), wt)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_one_epoch_bf16_matches_jax(small_graph, port_graph, backend):
    """One training step on bf16 X from the same weights and key: the
    loss within 1e-5; the NLL's dW₁ equal to JAX's or one bf16 ulp apart;
    the other weight gradients within rtol 1e-4 / atol 1e-5. The pallas
    arm runs JAX's Pallas kernel in interpret mode at the reduced
    geometry."""
    jprop = _jax_prop(small_graph, backend)
    jx = j_train.prepare_attr_input(small_graph, jprop, x_format="dense",
                                    x_dtype=jnp.bfloat16)
    labels = np.asarray(small_graph.labels)
    idx_train, _, _ = gen_splits(labels, SPLIT)
    n_features = small_graph.attr_matrix.shape[1]
    params = j_init_mlp_params(jax.random.PRNGKey(0), n_features, HIDDEN,
                               int(labels.max()) + 1)
    key = prng.fold_in(prng.split(prng.PRNGKey(3))[1], 4)
    reg = 5e-3

    def j_nll(p):
        logp = j_ppnp_forward(p, jx, jprop, jnp.asarray(idx_train),
                              key=jnp.asarray(key), train=True,
                              drop_prob=0.5)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels[idx_train])[:, None], axis=1))

    want_nll, want_grads = jax.value_and_grad(j_nll)(params)
    want_loss = want_nll + (reg / 2.0) * j_l2_reg(params)

    prop = _port_prop(port_graph, backend)
    x = t_train.prepare_attr_input(port_graph, prop, x_format="dense",
                                   x_dtype="bfloat16")
    model = params_from_jax([np.asarray(w) for w in params], device="cpu")
    idx = torch.from_numpy(idx_train)
    y = torch.from_numpy(labels[idx_train]).long()
    logp = ppnp_forward(model, x, prop, idx, key=key, train=True,
                        drop_prob=0.5)
    nll = t_train._nll(logp, y)
    grads = torch.autograd.grad(nll, list(model.parameters()))
    loss, _ = t_train.loss_and_grads(model, x, prop, idx, y, key=key,
                                     drop_prob=0.5, reg_lambda=reg)
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    assert_bf16_ulp(grads[0].numpy(), np.asarray(want_grads[0]).T)
    for got, want in zip(grads[1:], want_grads[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).T,
                                   **GRAD_TOL)


def _epoch_rows(text):
    rows = [json.loads(line) for line in text.splitlines()]
    return [r for r in rows if r["event"] == "epoch"]


def test_train_model_bf16_matches_jax(small_graph, port_graph):
    """``train_model`` with bf16 X on the xla arm, 30 epochs, patience 10:
    the same best and last epoch as JAX, per-epoch losses within 1e-4
    (module docstring); the weights stay f32."""
    kw = dict(backend="xla", niter=NITER, max_epochs=30, patience=10,
              seed=3, print_interval=0, x_format="dense",
              x_dtype="bfloat16",
              ntrain_per_class=SPLIT["ntrain_per_class"],
              nstopping=SPLIT["nstopping"], nknown=SPLIT["nknown"])
    jcfg = JRunConfig(**kw)
    jbuf = io.StringIO()
    jkw = j_builders.train_kwargs(jcfg)
    jkw["x_dtype"] = jnp.bfloat16
    _, want = j_train.train_model(
        small_graph, j_builders.build_propagator(jcfg, small_graph),
        metrics=JJsonlWriter(fileobj=jbuf), epoch_chunk=10, **jkw)
    cfg = RunConfig(**kw)
    tbuf = io.StringIO()
    model, got = t_train.train_model(
        port_graph, t_builders.build_propagator(cfg, port_graph,
                                                device="cpu"),
        metrics=JsonlWriter(fileobj=tbuf), epoch_chunk=10,
        **t_builders.train_kwargs(cfg))
    assert (got["last_epoch"], got["best_epoch"]) == (
        want["last_epoch"], want["best_epoch"])
    jrows, trows = _epoch_rows(jbuf.getvalue()), _epoch_rows(tbuf.getvalue())
    assert len(jrows) == len(trows) == want["last_epoch"] + 1
    for name in ("train_loss", "stopping_loss"):
        np.testing.assert_allclose([r[name] for r in trows],
                                   [r[name] for r in jrows],
                                   **TRAIN_LOSS_TOL)
    assert got["x_format"] == "dense"
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_train_models_bf16_matches_jax(small_graph, port_graph, backend):
    """G = 3 seeds batched on bf16 X (niter 3, 15 epochs, patience 3):
    each seed's best and last epoch equal JAX's ``train_models``."""
    kw = dict(drop_prob=0.5, test=True, x_format="dense",
              idx_split_args={"ntrain_per_class": 10, "nstopping": 40,
                              "nknown": 150},
              stopping_args={"max_epochs": 15, "patience": 3})
    want = j_train_models(small_graph, _jax_prop(small_graph, backend),
                          SEEDS, epoch_chunk=15, x_dtype=jnp.bfloat16, **kw)
    got = train_models(port_graph, _port_prop(port_graph, backend), SEEDS,
                       x_dtype="bfloat16", **kw)
    for (_, r), (_, w) in zip(got, want):
        assert (r["best_epoch"], r["last_epoch"]) == (w["best_epoch"],
                                                      w["last_epoch"])


def test_sparse_path_warns_and_runs_f32(port_graph, caplog):
    """On the sparse path a bf16 request logs JAX's warning and runs f32,
    staged or not; a dense staged X of another dtype raises, naming
    x_dtype (``tests/test_train.py:134-155``)."""
    prop = _port_prop(port_graph, "pallas")
    with caplog.at_level(logging.WARNING, logger="ppnp_tpu_torch.train"):
        xs = t_train.prepare_attr_input(port_graph, prop, x_format="sparse",
                                        x_dtype="bfloat16")
    assert isinstance(xs, SparseInput) and xs.csr.val.dtype == torch.float32
    assert "ignored on the sparse path" in caplog.text
    kw = dict(idx_split_args=SPLIT, print_interval=0,
              stopping_args={"max_epochs": 2, "patience": 10})
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ppnp_tpu_torch.train"):
        _, res = t_train.train_model(port_graph, prop, x_prepared=xs,
                                     x_format="sparse",
                                     x_dtype=torch.bfloat16, **kw)
    assert "ignored on the sparse path" in caplog.text
    assert res["x_format"] == "sparse"


def test_x_prepared_dtype_mismatch_rejected(port_graph):
    """A staged dense X that disagrees with an explicit x_dtype is
    rejected at the call boundary, naming the request; with no x_dtype a
    staged bf16 X trains as staged."""
    prop = _port_prop(port_graph, "xla")
    kw = dict(idx_split_args=SPLIT, print_interval=0,
              stopping_args={"max_epochs": 2, "patience": 10})
    x32 = t_train.prepare_attr_input(port_graph, prop, x_format="dense")
    with pytest.raises(ValueError, match="x_dtype=bfloat16"):
        t_train.train_model(port_graph, prop, x_prepared=x32,
                            x_dtype="bfloat16", **kw)
    x16 = t_train.prepare_attr_input(port_graph, prop, x_format="dense",
                                     x_dtype="bfloat16")
    with pytest.raises(ValueError, match="x_dtype=float32"):
        t_train.train_model(port_graph, prop, x_prepared=x16,
                            x_dtype="float32", **kw)
    _, res = t_train.train_model(port_graph, prop, x_prepared=x16, **kw)
    assert res["last_epoch"] == 1
    with pytest.raises(ValueError, match="float32 weights"):
        t_train.train_model(port_graph, prop, dtype=torch.bfloat16, **kw)


@pytest.fixture
def sbm_data(tmp_path, monkeypatch):
    """A graph large enough for the CLI's default splits with a test
    population, served under the dataset name ``sbm1800``."""
    graph = make_attributed_sbm(n_nodes=1800, n_classes=4, n_features=64,
                                n_edges=7200, seed=5)
    save_to_npz(tmp_path / "sbm1800.npz", graph)
    monkeypatch.setenv("PPNP_TPU_DATA", str(tmp_path))
    return "sbm1800"


def _cli_json(capsys, argv):
    capsys.readouterr()
    assert t_main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_train_and_predict_bf16(sbm_data, tmp_path, capsys):
    """``train --x-dtype bfloat16`` trains and checkpoints f32 weights;
    ``predict --x-dtype bfloat16`` serves them on bf16 X with the argmax
    of ``get_predictions`` on the same staged X."""
    common = ["--dataset", sbm_data, "--device", "cpu", "--k", "2",
              "--x-format", "dense", "--x-dtype", "bfloat16"]
    ckpt = tmp_path / "ck"
    res = _cli_json(capsys, ["train", *common, "--max-epochs", "3",
                             "--checkpoint-dir", str(ckpt)])
    assert res["last_epoch"] == 2 and res["config"]["x_dtype"] == "bfloat16"
    out = tmp_path / "p.npz"
    pred = _cli_json(capsys, ["predict", *common, "--checkpoint-dir",
                              str(ckpt), "--out", str(out)])
    assert pred["step"] == 2 and pred["accuracy_all_nodes"] > 0.25
    from ppnp_tpu_torch.checkpoint import restore_checkpoint
    from ppnp_tpu_torch.models.appnp import MLP
    state = restore_checkpoint(str(ckpt))
    assert all(v.dtype == torch.float32 for v in state["params"].values())
    cfg = RunConfig(dataset=sbm_data, niter=2)
    graph = t_builders.load_graph(cfg)
    prop = t_builders.build_propagator(cfg, graph, device="cpu")
    x = t_train.prepare_attr_input(graph, prop, x_format="dense",
                                   x_dtype="bfloat16")
    model = MLP.from_state_dict(state["best_state"], device="cpu")
    np.testing.assert_array_equal(np.load(out)["predictions"],
                                  t_train.get_predictions(model, x, prop))


def test_cli_reproduce_and_bench_bf16(sbm_data, tmp_path, capsys):
    """``reproduce --x-dtype bfloat16`` sweeps 2 batched seeds on bf16 X;
    ``bench --training`` reports the dtype that ran: bfloat16 dense,
    float32 on the sparse path."""
    capsys.readouterr()
    assert t_main(["reproduce", "--device", "cpu", "--datasets", sbm_data,
                   "--nseeds", "2", "--max-epochs", "3", "--k", "2",
                   "--backend", "pallas", "--x-format", "dense",
                   "--x-dtype", "bfloat16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"{sbm_data}: ")
    assert set(json.loads("\n".join(lines[1:]))) == {sbm_data}
    for x_format, ran in (("dense", "bfloat16"), ("sparse", "float32")):
        res = _cli_json(capsys, ["bench", "--dataset", sbm_data,
                                 "--training", "--epochs", "2",
                                 "--backends", "pallas", "--x-format",
                                 x_format, "--x-dtype", "bfloat16",
                                 "--device", "cpu"])
        assert res["x_dtype"] == ran and res["x_format"] == x_format
