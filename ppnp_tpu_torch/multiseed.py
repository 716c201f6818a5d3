"""Seed-batched training: train G seeds' models SIMULTANEOUSLY.

The port of ``ppnp_tpu/multiseed.py``. The paper's evaluation protocol
trains the same model under G seeds and reports mean ± CI; serially that
costs G× one run. Here the G models' local logits stack along the lanes of
one H (seed g's classes in columns [g·c, (g+1)·c)), so:

- eval-mode propagation shares Â's weights: one K1 launch per step on the
  stacked H (c = G·classes), and the eval sparse fc1 is one K1 launch on
  the lane-stacked W₁ (c = G·64);
- train-mode propagation gives each seed its own per-step edge-dropout
  plane through K2 (``kernels/spmm.py::spmm_csr_grouped``), all G·K planes
  drawn in one mask call (``ops/propagation.py::propagate_grouped``), and
  the train-mode sparse fc1 runs K2 on X with G id-keyed planes of X's
  values (its backward K2 on Xᵀ);
- the dense layers run per seed as batched matrix products (``torch.bmm``
  over a leading G axis, the counterpart of ``vmap``), with per-seed
  dropout keys; a bf16 dense X takes the mixed fc1 of ``ops/mixed.py``
  (in train mode one batched product of the G dropped bf16 copies, in
  eval mode one product against the lane-stacked ``bf16(W₁)``), each
  seed's dW rounded to bf16 as under JAX's ``vmap``; a sparse X runs f32
  whatever ``x_dtype`` asks, with ``train``'s warning;
- Adam runs on the G-stacked weights with a per-seed masked update
  (``optim.Adam.step(grads, mask)``), and early stopping and the best
  snapshot are tracked per seed.

Per-seed semantics mirror ``train.train_model`` key for key: each seed's
split, init, dropout masks and stopping decisions derive from its own
``PRNGKey(seed)`` chain, so a batched sweep reproduces the serial one.

What differs from the JAX package: the epoch loop is a Python loop, one
epoch at a time, that freezes each seed at its exact stopping epoch, so
the chunked ``lax.scan`` and its replay at an early stop
(``multiseed.py:365-411``) are not mirrored; ``epoch_chunk`` only groups
epochs in ``chunk_times``. The VMEM sub-batching of the grouped fc1
(``multiseed.py:101-109``) and the G > 6 warning (``multiseed.py:294-306``)
describe TPU limits and are not carried over.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ppnp_tpu_torch import preprocessing
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.earlystopping import EarlyStopping
from ppnp_tpu_torch.kernels.masks import edge_masks
from ppnp_tpu_torch.kernels.spmm import spmm_grad, spmm_grad_grouped
from ppnp_tpu_torch.metrics import JsonlWriter, accuracy, macro_f1
from ppnp_tpu_torch.models.appnp import MLP, init_mlp_params
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.dropout import dropout_grouped
from ppnp_tpu_torch.ops.mixed import mixed_matmul
from ppnp_tpu_torch.ops.propagation import (PPRPowerIteration,
                                            propagate_grouped)
from ppnp_tpu_torch.ops.sparse_input import SparseInput
from ppnp_tpu_torch.optim import Adam
from ppnp_tpu_torch.profiling import annotate, phase
from ppnp_tpu_torch.train import (_check_prepared_input,
                                  default_idx_split_args,
                                  default_stopping_args, prepare_attr_input)

logger = logging.getLogger(__name__)

__all__ = ["train_models", "grouped_forward"]


def _stack_lanes(h: torch.Tensor) -> torch.Tensor:
    """(G, n, c) → (n, G·c), group g in columns [g·c, (g+1)·c)."""
    return h.permute(1, 0, 2).reshape(h.shape[1], -1)


def _grouped_mlp(params_g: Sequence[torch.Tensor], x, keys_mlp, *,
                 train: bool, drop_prob: float, groups: int
                 ) -> torch.Tensor:
    """Per-seed MLP towers → (G, n, c) local logits.

    ``params_g``: (G, d_in, d_out) weights, the JAX package's layout with
    a leading seed axis; ``keys_mlp``: (G, 2), one MLP key per seed, split
    per layer as ``MLP.forward`` splits it, so every mask is the serial
    path's. Dropout precedes every layer, ReLU follows every layer but
    the last.
    """
    n_layers = len(params_g)
    use_drop = bool(train and drop_prob > 0.0 and keys_mlp is not None)
    keys = prng.split(keys_mlp, n_layers) if use_drop else None  # (G, L, 2)
    w1 = params_g[0]
    if isinstance(x, SparseInput):
        # fc1 = dropout_g(X) @ W1_g for every seed at once: K2 over X's
        # pattern with G id-keyed planes (train), K1 on the lane-stacked
        # W₁ with X's stored values (eval).
        n = x.shape[0]
        w1s = _stack_lanes(w1)                              # (f, G·h1)
        if use_drop:
            planes, planes_t = edge_masks(keys[:, 0], x.csr, x.csr_t,
                                          keep=1.0 - drop_prob)
            h = spmm_grad_grouped(x.csr, x.csr_t, w1s, planes, planes_t)
        else:
            h = spmm_grad(x.csr, x.csr_t, w1s)
        h = h.view(n, groups, -1).permute(1, 0, 2)         # (G, n, h1)
    elif x.dtype != w1.dtype:
        # bf16 X: the mixed fc1, per seed in train mode, lane-stacked in
        # eval mode (one product for every seed)
        if use_drop:
            h = mixed_matmul(dropout_grouped(keys[:, 0], x, drop_prob,
                                             shared=True), w1)
        else:
            h = mixed_matmul(x, _stack_lanes(w1))
            h = h.view(x.shape[0], groups, -1).permute(1, 0, 2)
    elif use_drop:
        h = torch.bmm(dropout_grouped(keys[:, 0], x, drop_prob, shared=True),
                      w1)
    else:
        h = torch.matmul(x, w1)
    for i in range(1, n_layers):
        h = F.relu(h)
        if use_drop:
            h = dropout_grouped(keys[:, i], h, drop_prob)
        h = torch.bmm(h, params_g[i])
    return h


def grouped_forward(params_g: Sequence[torch.Tensor], x, propagator,
                    idx_g: Optional[torch.Tensor] = None, keys_g=None, *,
                    train: bool = False, drop_prob: float = 0.5,
                    groups: int = 1) -> torch.Tensor:
    """Full PPNP forward for G seeds: MLP → propagate → per-seed idx →
    log_softmax. Returns (G, |idx|, c) log-probs, or (G, n, c) when
    ``idx_g`` is None. ``keys_g`` (G, 2) splits per seed into MLP and
    propagation keys, as ``ppnp_forward`` splits one key."""
    if keys_g is not None:
        ks = prng.split(keys_g)                             # (G, 2, 2)
        keys_mlp, keys_prop = ks[:, 0], ks[:, 1]
    else:
        keys_mlp = keys_prop = None
    with annotate("ppnp/grouped_mlp"):
        h = _grouped_mlp(params_g, x, keys_mlp, train=train,
                         drop_prob=drop_prob, groups=groups)
    n = h.shape[1]
    with annotate("ppnp/grouped_propagate"):
        z = propagate_grouped(propagator, _stack_lanes(h), keys_prop,
                              train=train, groups=groups)
    zg = z.view(n, groups, -1)
    if idx_g is None:
        sel = zg.permute(1, 0, 2)                           # (G, n, c)
    else:
        seed = torch.arange(groups, device=zg.device)[:, None]
        sel = zg[idx_g, seed]                               # (G, |idx|, c)
    return F.log_softmax(sel, dim=-1)


def _nll_g(logp: torch.Tensor, y_g: torch.Tensor) -> torch.Tensor:
    """Per-seed mean NLL: logp (G, m, c), y_g (G, m) → (G,), the mean as
    ``sum · (1/m)`` like ``train._mean``."""
    return -(logp.gather(2, y_g[:, :, None]).sum(dim=(1, 2))
             * (1.0 / y_g.shape[1]))


def _seed_model(params_g: Sequence[torch.Tensor], g: int) -> MLP:
    weights = [w[g] for w in params_g]
    dims = [weights[0].shape[0]] + [w.shape[1] for w in weights]
    model = MLP(dims, device=weights[0].device)
    with torch.no_grad():
        for lin, w in zip(model.layers, weights):
            lin.weight.copy_(w.t())
    return model


def train_models(
    graph: SparseGraph,
    propagator,
    seeds: Sequence[int],
    *,
    hidden_units: Sequence[int] = (64,),
    drop_prob: float = 0.5,
    learning_rate: float = 0.01,
    reg_lambda: float = 5e-3,
    idx_split_args: Optional[Dict[str, int]] = None,
    stopping_args: Optional[Dict[str, Any]] = None,
    test: bool = False,
    print_interval: int = 0,
    metrics: Optional[JsonlWriter] = None,
    dtype=None,
    epoch_chunk: int = 50,
    x_format: str = "auto",
    x_dtype=None,
    x_prepared=None,
) -> List[Tuple[MLP, Dict[str, Any]]]:
    """Train one model per seed, all simultaneously, on the propagator's
    device; returns ``[(model, result_dict)]`` in seed order with the keys
    of ``ppnp_tpu.multiseed.train_models`` — the batched equivalent of G
    serial ``train_model`` calls under the reproduce protocol (each seed
    drives both its split and its init and dropout streams).

    Supported propagators: ``PPRPowerIteration`` with backend ``pallas``
    or ``xla``. ``metrics`` receives one ``epoch`` row per epoch whose
    ``train_loss``, ``stopping_accuracy`` and ``stopping_loss`` are lists
    in seed order, with ``running`` marking the seeds not yet stopped,
    written after the epoch's ``ppnp/epoch`` span (``profiling``). The
    splits, the G inits and their copy to the device are the
    ``ppnp/setup/seeds`` phase.
    """
    if not (isinstance(propagator, PPRPowerIteration)
            and propagator.backend in ("pallas", "xla")):
        raise ValueError("train_models batches PPRPowerIteration on the "
                         "pallas or xla backend only")
    if dtype not in (None, torch.float32):
        raise ValueError(f"dtype={dtype}: the port trains float32 weights "
                         "(x_dtype narrows the attribute matrix alone)")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.time()
    groups = len(seeds)
    idx_split_args = dict(idx_split_args or default_idx_split_args)
    stop_args = dict(default_stopping_args)
    stop_args.update(stopping_args or {})
    max_epochs = int(stop_args.pop("max_epochs"))

    if x_prepared is not None:
        _check_prepared_input(x_prepared, graph, propagator,
                              x_format=x_format, x_dtype=x_dtype)
        x = x_prepared
    else:
        x = prepare_attr_input(graph, propagator, x_format=x_format,
                               x_dtype=x_dtype,
                               hidden=max(hidden_units, default=64))

    labels_np = np.asarray(graph.labels)
    n_classes = int(labels_np.max()) + 1
    dev = propagator.device

    def on_dev(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    with phase("ppnp/setup/seeds"):
        splits = [preprocessing.gen_splits(
            labels_np, dict(idx_split_args, seed=int(s) & 0x7FFFFFFF), test)
            for s in seeds]
        idx_train_g = on_dev(np.stack([s[0] for s in splits]))
        idx_stop_g = on_dev(np.stack([s[1] for s in splits]))
        y_train_g = on_dev(np.stack([labels_np[s[0]] for s in splits]))
        y_stop_g = on_dev(np.stack([labels_np[s[1]] for s in splits]))
        key_epochs_g, models = [], []
        for s in seeds:
            k_init, k_epochs = prng.split(prng.PRNGKey(int(s)))
            models.append(init_mlp_params(x.shape[1], list(hidden_units),
                                          n_classes, key=k_init,
                                          device="cpu"))
            key_epochs_g.append(k_epochs)
        key_epochs_g = np.stack(key_epochs_g)              # (G, 2)
        params_g = [torch.stack([m.layers[i].weight.t() for m in models])
                    .to(dev).requires_grad_()
                    for i in range(len(models[0].layers))]  # (G, d_in, d_out)
    optimizer = Adam(params_g, lr=learning_rate)

    # per seed: best weights, stopping acc and loss, epoch (-1: none yet)
    best_params = [p.detach().clone() for p in params_g]
    best_acc = np.full(groups, -np.inf, np.float32)
    best_loss = np.full(groups, np.inf, np.float32)
    best_epoch = np.full(groups, -1, np.int64)
    es = [EarlyStopping(**stop_args) for _ in seeds]
    stopped = np.zeros(groups, bool)
    last_epoch = np.zeros(groups, np.int64)

    @torch.no_grad()
    def where_seeds(mask_np, new, old):
        """Per seed: ``new`` where ``mask_np`` (G,) is True, else ``old``."""
        m = torch.from_numpy(mask_np).to(dev)
        return [torch.where(m.view((-1,) + (1,) * (o.dim() - 1)), nw, o)
                for nw, o in zip(new, old)]

    def run_epoch(epoch: int, active: torch.Tensor) -> torch.Tensor:
        """One step and the stopping eval; the epoch's 3·G scalars, on
        the device (the caller reads them back after this frame's
        tensors are freed, while the device still runs the eval)."""
        with annotate("ppnp/forward"):
            keys_g = prng.fold_in(key_epochs_g, epoch)    # (G, 2)
            logp = grouped_forward(params_g, x, propagator, idx_train_g,
                                   keys_g, train=True, drop_prob=drop_prob,
                                   groups=groups)
            loss_g = _nll_g(logp, y_train_g) + (reg_lambda / 2.0) \
                * torch.sum(params_g[0] ** 2, dim=(1, 2))
            loss = loss_g.sum()
        with annotate("ppnp/backward"):
            grads = torch.autograd.grad(loss, params_g)
        with annotate("ppnp/optimizer"):
            optimizer.step(grads, mask=active)
        with torch.no_grad(), annotate("ppnp/eval"):
            logp = grouped_forward(params_g, x, propagator, idx_stop_g,
                                   train=False, groups=groups)
            stop_loss_g = _nll_g(logp, y_stop_g)
            stop_acc_g = ((logp.argmax(dim=-1) == y_stop_g).float()
                          .sum(dim=1) * (1.0 / y_stop_g.shape[1]))
            return torch.stack([loss_g.detach(), stop_acc_g, stop_loss_g])

    chunk_start = 0
    chunk_times: list = []
    active = torch.ones(groups, dtype=torch.bool, device=dev)
    while chunk_start < max_epochs and not stopped.all():
        t_chunk = time.perf_counter()
        count = min(epoch_chunk, max_epochs - chunk_start)
        ran = 0
        for epoch in range(chunk_start, chunk_start + count):
            with annotate("ppnp/epoch"):
                scalars = run_epoch(epoch, active)
                with annotate("ppnp/readback"):
                    # one device-to-host copy for the epoch's 3·G scalars
                    losses, accs, stop_losses = scalars.cpu().numpy()
                with annotate("ppnp/bookkeeping"):
                    ran += 1
                    act = ~stopped
                    if not np.isfinite(losses[act]).all():
                        g_bad = int(np.where(act & ~np.isfinite(losses))[0][0])
                        raise FloatingPointError(
                            f"non-finite training loss at epoch {epoch} "
                            f"(seed {seeds[g_bad]}, index {g_bad})")
                    last_epoch[act] = epoch
                    improved = act & ((accs > best_acc) | (
                        (accs == best_acc) & (stop_losses < best_loss)))
                    if improved.any():
                        best_params = where_seeds(improved, params_g,
                                                  best_params)
                        best_acc = np.where(improved, accs, best_acc)
                        best_loss = np.where(improved, stop_losses,
                                             best_loss)
                        best_epoch[improved] = epoch
                    for g in np.where(act)[0]:
                        if es[g].check([float(accs[g]),
                                        float(stop_losses[g])], epoch):
                            stopped[g] = True
                    if stopped.any() and not stopped.all():
                        active = torch.from_numpy(~stopped).to(dev)
            if metrics is not None:
                with annotate("ppnp/metrics"):
                    metrics.write(event="epoch", epoch=epoch,
                                  seeds=[int(s) for s in seeds],
                                  running=act.tolist(),
                                  train_loss=losses.tolist(),
                                  stopping_accuracy=accs.tolist(),
                                  stopping_loss=stop_losses.tolist())
            if print_interval and epoch % print_interval == 0:
                logger.info("epoch %4d: mean stopping acc %.4f (%d/%d seeds "
                            "running)", epoch, float(accs.mean()),
                            int((~stopped).sum()), groups)
            if stopped.all():
                break
        chunk_times.append((ran, time.perf_counter() - t_chunk))
        chunk_start += count

    with torch.no_grad():
        params_g = where_seeds(best_epoch >= 0, best_params, params_g)
        logp = grouped_forward(params_g, x, propagator, None, train=False,
                               groups=groups)
        preds_g = logp.argmax(dim=-1).cpu().numpy()        # (G, n)

    runtime = time.time() - t_start
    results = []
    for g in range(groups):
        res: Dict[str, Any] = {}
        for name, idx in zip(("train", "early_stopping", "valtest"),
                             splits[g]):
            res[name] = {
                "accuracy": accuracy(labels_np[idx], preds_g[g][idx]),
                "f1_score": macro_f1(labels_np[idx], preds_g[g][idx],
                                     n_classes),
            }
        nepochs = int(last_epoch[g]) + 1
        res.update(
            runtime=runtime, runtime_perepoch=runtime / max(nepochs, 1),
            last_epoch=int(last_epoch[g]), best_epoch=int(best_epoch[g]),
            chunk_times=chunk_times, seed=int(seeds[g]),
            batched_seeds=groups, predictions=preds_g[g],
        )
        results.append((_seed_model(params_g, g), res))
    return results
