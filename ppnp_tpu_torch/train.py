"""Training loop: full-batch Adam with dual-criterion early stopping, and
the serving helpers ``prepare_attr_input`` and ``get_predictions``.

Counterpart of ``ppnp_tpu/train.py``, with the same signature, key
schedule and result dict:

- splits from ``preprocessing.gen_splits``;
- ``key_init, key_epochs = split(PRNGKey(seed))``, the epoch key
  ``fold_in(key_epochs, e)`` (``train.py:139,396-397``), weights from
  ``init_mlp_params(key_init, ...)`` — so the port draws the JAX
  package's weights and masks bit for bit;
- loss = NLL on ``idx_train`` + ``reg_lambda/2·‖W₁‖²``; one Adam step per
  epoch (``optim.Adam``, optax's arithmetic); then the eval forward on
  the stopping set;
- best snapshot: higher stopping accuracy, ties to lower loss
  (``train.py:164-174``); ``EarlyStopping.check`` decides when to stop;
- checkpoints every ``checkpoint_every`` epochs (at the end of an epoch
  chunk, as the JAX package saves) and at the end, ``resume`` from the
  latest; the best weights are restored for the final evaluation.

What differs, and why: the epoch loop is a Python loop, one epoch at a
time. The JAX package ran ``epoch_chunk`` epochs inside one compiled
``lax.scan`` with a replay of the chunk at an early stop and batched
host transfers (``_host_scalars``), to amortise the TPU's dispatch and
transfer latency; PyTorch on the card runs eagerly, and one epoch reads
its three scalars with one device-to-host copy. ``chunk_times`` still
groups epochs by ``epoch_chunk``. ``profile_dir`` traces the
steady-state chunks with ``torch.profiler`` (``profiling.trace``); each
epoch is a ``ppnp/epoch`` span holding its phases' spans
(``profiling``'s docstring), and the ``metrics`` row is written after
it.

Matmuls run in full float32 (``allow_tf32`` off), as the JAX reference
computes at f32. ``x_dtype=bfloat16`` stores only a dense X in bf16; fc1
is then the mixed product of ``ops/mixed.py`` (bf16 operands, f32 sums),
and the weights, Adam's state and every activation after fc1 stay f32.
The sparse path runs f32 whatever ``x_dtype`` asks, with the JAX
package's warning.

Under a row-sharded propagator (``parallel/sharded.py``,
``parallel/hier.py``) every rank runs ``train_model`` on its rows of X,
the data-parallel MLP of ``ppnp_tpu/train.py`` under GSPMD: the weights
are replicated, the loss and the stopping-set eval read the rows of
their ids gathered to every rank, so every rank computes the same loss,
accuracy and early-stopping decisions. The gradient rule is that of
``parallel/sharded.py``: each rank's gradient of the NLL is its rows'
part; ``all_reduce_sum`` adds the parts in one collective an epoch
(with bf16 X the summed fc1 gradient is then rounded to bf16, as JAX
rounds the dot of its global program), the L2 term's gradient
``reg_lambda·W₁`` is added once after it, and Adam steps the same weights on every rank. Only rank 0 logs, writes metrics
and writes checkpoints; ``resume`` restores on every rank.

``get_predictions`` serves a repeated request on the card from CUDA
graphs of its kernels, captured once per operand set (its docstring);
``REQUEST_GRAPHS`` counts how each request was served.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ppnp_tpu_torch import preprocessing
from ppnp_tpu_torch.data.sparsegraph import SparseGraph
from ppnp_tpu_torch.earlystopping import EarlyStopping
from ppnp_tpu_torch.earlystopping import stopping_args as \
    default_stopping_args
from ppnp_tpu_torch.metrics import JsonlWriter, accuracy, macro_f1
from ppnp_tpu_torch.models.appnp import (MLP, init_mlp_params, l2_reg,
                                         mlp_forward, ppnp_forward)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.exact import PPRExact
from ppnp_tpu_torch.ops.mixed import round_like
from ppnp_tpu_torch.ops.propagation import PPRPowerIteration
from ppnp_tpu_torch.ops.sparse_input import (ShardedSparseInput,
                                             SparseInput,
                                             build_sharded_sparse_input,
                                             build_sparse_input)
from ppnp_tpu_torch.optim import Adam
from ppnp_tpu_torch.parallel.mesh import all_reduce_sum, is_rank0
from ppnp_tpu_torch.parallel.sharded import RowSharded, all_gather_rows
from ppnp_tpu_torch.profiling import annotate, phase, trace

logger = logging.getLogger(__name__)

__all__ = ["train_model", "get_predictions", "prepare_attr_input",
           "loss_and_grads", "default_idx_split_args", "REQUEST_GRAPHS",
           "reset_request_graphs", "request_mode"]

_X_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The JAX package's VMEM limit (``ppnp_tpu/kernels/spmm.py:68``), the
# bound on the sparse fc1's operands in its "auto" rule: kept so that
# "auto" picks the JAX layout of X, and so the same dropout stream.
_FC1_SPARSE_LIMIT_BYTES = 100 * 1024 * 1024

default_idx_split_args: Dict[str, int] = {
    "ntrain_per_class": 20,
    "nstopping": 500,
    "nknown": 1500,
    "seed": 2413340114,
}


def _as_x_dtype(x_dtype) -> Optional[torch.dtype]:
    """``x_dtype`` as a torch dtype: None (the float32 default),
    "float32"/"bfloat16" or those torch dtypes."""
    if x_dtype is None:
        return None
    dtype = _X_DTYPES.get(x_dtype, x_dtype)
    if dtype not in _X_DTYPES.values():
        raise ValueError(f"x_dtype={x_dtype!r}: expected None, float32 "
                         "or bfloat16")
    return dtype


def _warn_sparse_dtype(dtype: Optional[torch.dtype]) -> None:
    if dtype not in (None, torch.float32):
        logger.warning("x_dtype=%s ignored on the sparse path (the CSR "
                       "fc1 kernel runs float32)",
                       str(dtype).removeprefix("torch."))


@phase("ppnp/setup/attr")
def prepare_attr_input(graph: SparseGraph, propagator, *,
                       x_format: str = "auto", x_dtype=None,
                       hidden: int = 64):
    """L1-normalize the attribute matrix and stage it on the propagator's
    device, dense or as a ``SparseInput`` (fc1 through K1; X and Xᵀ in
    CSR, ``build_sparse_input``).

    ``x_format``: "dense" densifies X (fc1 is then one f32
    ``torch.matmul``); "sparse" keeps it CSR; "auto" applies the JAX
    rule (``ppnp_tpu/train.py:208-218``), threshold included: sparse
    exactly when X is scipy-sparse, its dense form has at least 16 M
    entries (n·f ≥ 16,000,000), at most 5 % of them are nonzero, and the
    fc1 operands that the TPU kernel keeps in VMEM,
    ``(3·n + 2·f)·hidden·4`` bytes, fit ``_FC1_SPARSE_LIMIT_BYTES``
    (100 MiB). That bound describes the TPU, not this card, but dense and
    sparse fc1 draw different dropout streams, so the layout decides
    which model a call trains: the port keeps the JAX threshold so that
    ``auto`` trains the same model. ``hidden`` is the first hidden width
    (``train_model`` passes ``max(hidden_units)``). On the four
    surrogates at hidden 64 only ms_academic is sparse (n·f = 124.7 M at
    0.12 % density, 17.6 MB of fc1 operands); from n ≈ 136 k at hidden
    64 X stays dense.

    ``x_dtype``: None or float32, or bfloat16 (``_as_x_dtype``): a
    dense X is staged as ``bf16(f32 X)`` (round to nearest even, as
    ``jnp.asarray(x, bfloat16)``), and fc1 is the mixed product of
    ``ops/mixed.py``; the sparse path ignores it with the JAX package's
    warning and runs f32 (``ppnp_tpu/train.py:222-227``).

    A row-sharded propagator gets this rank's rows of X
    (``RowSharded.row_range``), zero-padded at the tail of the last rank
    to the plan's ``n_pad`` rows: dense, or with "sparse" a
    ``ShardedSparseInput``; "auto" picks dense there, as the JAX rule
    does (``ppnp_tpu/train.py:215``).

    Timed as the ``ppnp/setup/attr`` phase (``profiling.phase``).
    """
    dtype = _as_x_dtype(x_dtype)
    attr_norm = preprocessing.normalize_attributes(graph.attr_matrix)
    device = propagator.device
    sharded = isinstance(propagator, RowSharded)
    n, f = attr_norm.shape
    if x_format == "auto":
        # every unsharded arm has n rows (JAX: edges.n_rows = n)
        fc1_bytes = (3 * n + 2 * f) * hidden * 4
        use_sparse = (sp.issparse(attr_norm) and not sharded
                      and n * f >= 16_000_000
                      and attr_norm.nnz <= 0.05 * n * f
                      and fc1_bytes <= _FC1_SPARSE_LIMIT_BYTES)
    elif x_format in ("dense", "sparse"):
        use_sparse = x_format == "sparse"
    else:
        raise ValueError(f"unknown x_format {x_format!r} "
                         "(expected 'auto', 'dense' or 'sparse')")
    if use_sparse:
        _warn_sparse_dtype(dtype)
    if use_sparse and sharded:
        g = propagator.graph
        return build_sharded_sparse_input(
            attr_norm, shard_rows=g.shard_rows, n_shards=g.n_shards,
            rank=propagator.mesh.rank, device=device)
    if use_sparse:
        return build_sparse_input(attr_norm, device=device)
    if sharded:
        lo, hi = propagator.row_range
        attr_norm = attr_norm[lo:min(hi, n)]
    x_np = (np.asarray(attr_norm.todense(), dtype=np.float32)
            if sp.issparse(attr_norm)
            else np.asarray(attr_norm, dtype=np.float32))
    if sharded:
        x_np = np.pad(x_np, ((0, hi - lo - x_np.shape[0]), (0, 0)))
    return torch.from_numpy(x_np).to(dtype or torch.float32).to(device)


def _check_prepared_input(x, graph: SparseGraph, propagator, *,
                          x_format: str, x_dtype) -> None:
    """Validate a caller-staged ``x_prepared`` (``train.py:264-317``):
    a staged X silently overrides ``x_format``/``x_dtype``; under a
    row-sharded propagator it must be this rank's rows. A requested
    ``x_dtype`` must be a dense X's dtype; the sparse path warns and runs
    f32, as ``prepare_attr_input`` does."""
    is_sparse = isinstance(x, SparseInput)
    sharded = isinstance(propagator, RowSharded)
    if x_format == "sparse" and not is_sparse:
        raise ValueError("x_prepared is a dense tensor but x_format="
                         "'sparse' was requested; re-stage with "
                         "prepare_attr_input(..., x_format='sparse')")
    if x_format == "dense" and is_sparse:
        raise ValueError("x_prepared is a SparseInput but x_format="
                         "'dense' was requested; re-stage with "
                         "prepare_attr_input(..., x_format='dense')")
    if is_sparse and sharded != isinstance(x, ShardedSparseInput):
        raise ValueError(
            "x_prepared is a " + type(x).__name__ + " but the propagator "
            "is " + ("" if sharded else "not ") + "row-sharded; re-stage "
            "with prepare_attr_input(graph, propagator, x_format='sparse')")
    want = tuple(graph.attr_matrix.shape)
    if sharded:
        want = (propagator.graph.shard_rows, want[1])
    if tuple(x.shape) != want:
        raise ValueError(
            f"x_prepared has shape {tuple(x.shape)} but this (graph, "
            f"propagator) needs {want}; it was staged for a different "
            "graph or propagator")
    want = _as_x_dtype(x_dtype)
    if want is None:
        return
    if is_sparse:
        _warn_sparse_dtype(want)
    elif x.dtype != want:
        name = str(want).removeprefix("torch.")
        raise ValueError(
            f"x_dtype={name} requested but x_prepared was staged as "
            f"{str(x.dtype).removeprefix('torch.')}; re-stage with "
            "prepare_attr_input(..., x_dtype=...)")


def get_predictions(model: MLP, x, propagator) -> np.ndarray:
    """Argmax class predictions for all nodes (eval mode); under a
    sharded propagator every rank gets all ``n_pad`` rows' predictions
    (the caller keeps the first n).

    Dense fc1 runs in full float32: TF32 matmuls are switched off here
    (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)
    so the card computes what the JAX reference computes at f32.

    Repeated requests replay CUDA graphs (``request_mode``): on the card,
    with a one-card propagator, the second request of an operand set
    (this ``x`` and propagator object, the weights' shapes and dtypes,
    the storage of every tensor ``x`` and the propagator hold) captures
    the request's kernels, and later ones replay them with the served
    weights copied in first, so the answer follows weights changed in
    place. The first request, and every request on the CPU or under a
    row-sharded propagator, runs eagerly. ``REQUEST_GRAPHS`` counts the
    three; ``build.LAUNCHES`` counts the kernels' wrapper calls, which a
    replay makes none of. Each call returns a new array.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    with annotate("ppnp/request"), torch.no_grad():
        dev = propagator.device
        weights = [lin.weight for lin in model.layers]
        head, seen = None, 0
        if _graphable(dev.type, type(propagator)):
            head = (dev, id(x), id(propagator),
                    tuple((w.shape, w.dtype) for w in weights),
                    torch.are_deterministic_algorithms_enabled())
            seen = _times_seen(head, x, propagator)
        mode = request_mode(dev.type, type(propagator), seen)
        if mode == "replay":
            REQUEST_GRAPHS["replayed"] += 1
            _REQUEST_CACHE.move_to_end(head)
            return _REQUEST_CACHE[head].replay(weights)
        if mode == "capture":
            graphs = _RequestGraphs(model, x, propagator)
            preds = graphs.capture(weights)
            REQUEST_GRAPHS["captured"] += 1
            _remember(head, graphs)
            return preds
        REQUEST_GRAPHS["eager"] += 1
        if head is not None:
            _remember(head, _signature(_operands(x, propagator)[0]))
        logp = ppnp_forward(model, x, propagator, None, train=False)
        with annotate("ppnp/readback"):
            preds = logp.argmax(dim=-1)
            if isinstance(propagator, RowSharded):
                preds = all_gather_rows(preds, propagator.mesh)
            return preds.cpu().numpy()


# get_predictions' requests: served eagerly, captured into CUDA graphs
# (an operand set's second request) and replayed from them
REQUEST_GRAPHS: Dict[str, int] = {"eager": 0, "captured": 0, "replayed": 0}
# (device, x, propagator, weights' shapes and dtypes, deterministic
# algorithms) -> the graphs of its operand set, or the signature of the
# one seen once; least recently used first
_REQUEST_CACHE: collections.OrderedDict = collections.OrderedDict()
# operand sets kept; a dropped one frees its graphs and their memory pool
_GRAPH_CAP = 4
# one card's propagators, whose kernels a graph captures; the row-sharded
# ones (RowSharded, HierShardedPowerIteration) exchange rows through NCCL
# collectives, which stay eager
_GRAPHED = (PPRPowerIteration, PPRExact)
# per device, the stream graphs are captured on (``_RequestGraphs``)
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def reset_request_graphs() -> None:
    """Set the counts of ``REQUEST_GRAPHS`` to 0."""
    for name in REQUEST_GRAPHS:
        REQUEST_GRAPHS[name] = 0


def _graphable(device_type: str, propagator_type: type) -> bool:
    return device_type == "cuda" and issubclass(propagator_type, _GRAPHED)


def request_mode(device_type: str, propagator_type: type, seen: int) -> str:
    """How ``get_predictions`` serves a request: "eager" off the card,
    under a propagator that is not one card's, and for an operand set's
    first request (``seen`` = its requests before this one); "capture"
    for its second; "replay" after that."""
    if not _graphable(device_type, propagator_type) or seen == 0:
        return "eager"
    return "capture" if seen == 1 else "replay"


def _walk(obj, tensors: list, bindings: list) -> bool:
    """Add the tensors ``obj`` holds to ``tensors`` (itself, or those of
    its items, of a list, tuple or dict, or attributes, of a module or
    dataclass, recursively), and to ``bindings`` each (mapping, name,
    object) on the way to one; whether it holds any."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return True
    if isinstance(obj, (list, tuple)):
        where, items = obj, enumerate(obj)
    elif isinstance(obj, dict):
        where, items = obj, obj.items()
    elif isinstance(obj, torch.nn.Module) or dataclasses.is_dataclass(obj):
        where = vars(obj)
        items = where.items()
    else:
        return False
    found = False
    for name, item in list(items):
        if _walk(item, tensors, bindings):
            bindings.append((where, name, item))
            found = True
    return found


def _operands(x, propagator) -> Tuple[list, list]:
    """The tensors ``x`` and the propagator hold, and the bindings that
    reach them (``_walk``)."""
    tensors: list = []
    bindings: list = []
    _walk(x, tensors, bindings)
    _walk(propagator, tensors, bindings)
    return tensors, bindings


def _pointers(tensors: list) -> tuple:
    return tuple(map(torch.Tensor.data_ptr, tensors))


def _signature(tensors: list) -> tuple:
    return _pointers(tensors), tuple(map(torch.Tensor.size, tensors))


def _times_seen(head: tuple, x, propagator) -> int:
    """Earlier requests of this request's operand set, counted to 2: an
    operand set cached under ``head`` whose bindings or storages have
    changed since is a new one."""
    kept = _REQUEST_CACHE.get(head)
    if isinstance(kept, _RequestGraphs):
        return 2 if kept.current() else 0
    if kept is None:
        return 0
    return 1 if kept == _signature(_operands(x, propagator)[0]) else 0


def _remember(head: tuple, kept) -> None:
    _REQUEST_CACHE[head] = kept
    _REQUEST_CACHE.move_to_end(head)
    while len(_REQUEST_CACHE) > _GRAPH_CAP:
        _REQUEST_CACHE.popitem(last=False)


class _RequestGraphs:
    """One operand set's request as three CUDA graphs, one per span of
    the request, sharing a memory pool: the MLP (``ppnp/mlp``), the
    propagation (``ppnp/propagate``), log-softmax and argmax
    (``ppnp/readback``). The served weights are copied into ``weights``
    before each replay. Holds ``x``, the propagator and the tensors they
    hold, so nothing the graphs read is freed while it lives."""

    def __init__(self, model: MLP, x, propagator):
        self.x, self.propagator = x, propagator
        self.tensors, self.bindings = _operands(x, propagator)
        self.pointers = _pointers(self.tensors)
        self.model = copy.deepcopy(model)
        # plain tensors on the parameters' storage: a copy into a
        # Parameter costs the host more than the card's memcpy takes
        self.weights = [lin.weight.detach() for lin in self.model.layers]
        self.graphs: list = []
        self.outputs: tuple = ()

    def current(self) -> bool:
        """Whether every binding still holds its object and every tensor
        its storage."""
        try:
            for where, name, item in self.bindings:
                if where[name] is not item:
                    return False
        except (KeyError, IndexError):  # an attribute or item removed
            return False
        return _pointers(self.tensors) == self.pointers

    def _load(self, weights) -> None:
        for static, w in zip(self.weights, weights):
            static.copy_(w)

    def _stages(self):
        """The request's three stages, each a function of the one
        before's output."""
        def mlp(_):
            return mlp_forward(self.model, self.x, train=False)

        def propagate(h):
            return self.propagator(h, None, train=False)

        def readback(z):
            logp = F.log_softmax(z, dim=-1)
            return logp, logp.argmax(dim=-1)
        return mlp, propagate, readback

    def capture(self, weights) -> np.ndarray:
        """Run the request once eagerly on the capture stream (its
        answer is returned), then capture its stages there. The eager
        run makes, outside the graphs' pool, what the kernels keep per
        stream: K3's sync words (``kernels/fused.py``), cuBLAS's
        workspace."""
        dev = self.propagator.device
        stream = _CAPTURE_STREAMS.get(dev.index)
        if stream is None:
            stream = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._load(weights)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = None
            for stage in self._stages():
                out = stage(out)
        pool = torch.cuda.graph_pool_handle()
        outputs = None
        # every stage's outputs stay referenced (``self.outputs``), so no
        # later capture in the pool takes their memory
        for stage in self._stages():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outputs = stage(outputs)
            self.graphs.append(graph)
            self.outputs += (outputs,)
        current.wait_stream(stream)
        return out[1].cpu().numpy()

    def replay(self, weights) -> np.ndarray:
        """The request for ``weights``, from the graphs; a new host
        array each call."""
        mlp, propagate, readback = self.graphs
        with annotate("ppnp/mlp"):
            self._load(weights)
            mlp.replay()
        with annotate("ppnp/propagate"):
            propagate.replay()
        with annotate("ppnp/readback"):
            readback.replay()
            return self.outputs[-1][1].cpu().numpy()


def _mean(x: torch.Tensor) -> torch.Tensor:
    # sum · f32(1/n), as XLA computes jnp.mean; a true division rounds
    # the last bit of a stopping accuracy such as 14/60 differently
    return x.sum() * (1.0 / x.numel())


def _nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -_mean(log_probs.gather(1, labels[:, None]))


def loss_and_grads(model: MLP, x, propagator, idx: torch.Tensor,
                   y: torch.Tensor, *, key, drop_prob: float,
                   reg_lambda: float):
    """One training step's loss (NLL on ``idx`` + ``reg_lambda/2·‖W₁‖²``)
    and the weights' gradients, the same on every rank of a row-sharded
    propagator: there the ranks' parts of the NLL's gradient are summed
    in one all-reduce, fc1's rounded to bf16 when X is bf16, and the L2
    term's added once after it (``parallel/sharded.py``'s gradient
    rule). The forward is a ``ppnp/forward`` span, the gradients (and
    their all-reduce) a ``ppnp/backward`` one."""
    params = [lin.weight for lin in model.layers]
    with annotate("ppnp/forward"):
        logp = ppnp_forward(model, x, propagator, idx, key=key, train=True,
                            drop_prob=drop_prob)
        nll = _nll(logp, y)
        loss = nll + (reg_lambda / 2.0) * l2_reg(model)
    with annotate("ppnp/backward"):
        if not isinstance(propagator, RowSharded):
            grads = list(torch.autograd.grad(loss, params))
        else:
            grads = all_reduce_sum(list(torch.autograd.grad(nll, params)),
                                   propagator.mesh)
            if not isinstance(x, SparseInput) and x.dtype != params[0].dtype:
                # the mixed fc1 left its dW unrounded: round the summed one
                grads[0] = round_like(grads[0], x.dtype)
            grads[0] = grads[0] + reg_lambda * params[0].detach()
        return loss, grads


def _snapshot(model: MLP):
    return [lin.weight.detach().clone() for lin in model.layers]


def _state_dict(weights) -> Dict[str, torch.Tensor]:
    return {f"layers.{i}.weight": w.detach().cpu()
            for i, w in enumerate(weights)}


def train_model(
    graph: SparseGraph,
    propagator,
    *,
    hidden_units: Sequence[int] = (64,),
    drop_prob: float = 0.5,
    learning_rate: float = 0.01,
    reg_lambda: float = 5e-3,
    idx_split_args: Optional[Dict[str, int]] = None,
    stopping_args: Optional[Dict[str, Any]] = None,
    test: bool = False,
    seed: int = 0,
    print_interval: int = 20,
    metrics: Optional[JsonlWriter] = None,
    dtype=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 500,
    resume: bool = False,
    epoch_chunk: int = 50,
    profile_dir: Optional[str] = None,
    x_dtype=None,
    x_format: str = "auto",
    x_prepared=None,
) -> Tuple[MLP, Dict[str, Any]]:
    """Train PPNP/APPNP on a graph on the propagator's device; returns
    (model, result_dict) with the keys of ``ppnp_tpu.train.train_model``.

    ``dtype``: the weights' dtype, float32 only (``None`` or
    ``torch.float32``); ``x_dtype`` narrows the attribute matrix alone.
    Under a row-sharded propagator every rank calls it (module
    docstring). ``epoch_chunk`` groups epochs in ``chunk_times`` and fixes
    where ``checkpoint_every`` saves land, as in the JAX package.

    ``profile_dir``: trace the steady-state chunks into that directory
    (``profiling.trace``): from the end of the first chunk on, or from
    the start when one chunk holds the run. A run that stops inside its
    first chunk traces its final eval forward instead, so the directory
    is never left empty (``ppnp_tpu/train.py:494-589``).
    """
    if dtype not in (None, torch.float32):
        raise ValueError(f"dtype={dtype}: the port trains float32 weights "
                         "(x_dtype narrows the attribute matrix alone)")
    torch.backends.cuda.matmul.allow_tf32 = False
    log = logger.info if is_rank0() else logger.debug
    t_start = time.time()
    idx_split_args = dict(idx_split_args or default_idx_split_args)
    stop_args = dict(default_stopping_args)
    stop_args.update(stopping_args or {})
    max_epochs = int(stop_args.pop("max_epochs"))

    labels_np = np.asarray(graph.labels)
    idx_train_np, idx_stop_np, idx_valtest_np = preprocessing.gen_splits(
        labels_np, idx_split_args, test=test)

    if x_prepared is not None:
        _check_prepared_input(x_prepared, graph, propagator,
                              x_format=x_format, x_dtype=x_dtype)
        x = x_prepared
    else:
        x = prepare_attr_input(graph, propagator, x_format=x_format,
                               x_dtype=x_dtype,
                               hidden=max(hidden_units, default=64))

    dev = propagator.device

    def on_dev(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)

    idx_train, idx_stop = on_dev(idx_train_np), on_dev(idx_stop_np)
    y_train = on_dev(labels_np[idx_train_np])
    y_stop = on_dev(labels_np[idx_stop_np])

    key_init, key_epochs = prng.split(prng.PRNGKey(seed))
    n_classes = int(labels_np.max()) + 1
    model = init_mlp_params(x.shape[1], list(hidden_units), n_classes,
                            key=key_init, device=dev)
    params = [lin.weight for lin in model.layers]
    optimizer = Adam(params, lr=learning_rate)

    early_stopping = EarlyStopping(
        stop_varnames=stop_args["stop_varnames"],
        patience=stop_args["patience"],
        max_epochs=max_epochs)
    # (weights, stopping acc, stopping loss, epoch) of the best epoch
    best = (_snapshot(model), -np.inf, np.inf, -1)
    start_epoch = 0
    if resume and checkpoint_dir is not None:
        from ppnp_tpu_torch import checkpoint as ckpt_mod
        state = ckpt_mod.restore_checkpoint(checkpoint_dir)
        if state is not None:
            with torch.no_grad():
                model.load_state_dict(state["params"])
            optimizer.load_state_dict(state["opt_state"])
            start_epoch = int(state["epoch"]) + 1
            es = state["early_stopping"]
            early_stopping.best_vals = [float(v) for v in es["best_vals"]]
            early_stopping.patience = int(es["patience"])
            early_stopping._best_acc = float(es["best_acc"])
            early_stopping._best_loss = float(es["best_loss"])
            early_stopping.best_epoch = (int(es["best_epoch"])
                                         if es["best_epoch"] >= 0 else None)
            best = ([state["best_state"][f"layers.{i}.weight"].to(dev)
                     for i in range(len(params))],
                    float(es["best_acc"]), float(es["best_loss"]),
                    int(es["best_epoch"]))
            log("resumed from epoch %d", start_epoch)

    def _save(epoch):
        from ppnp_tpu_torch import checkpoint as ckpt_mod
        ckpt_mod.save_checkpoint(checkpoint_dir, epoch, {
            "params": _state_dict(params),
            "opt_state": optimizer.state_dict(),
            "epoch": epoch,
            "early_stopping": {
                "best_vals": [float(v) for v in early_stopping.best_vals],
                "patience": early_stopping.patience,
                "best_acc": float(best[1]),
                "best_loss": float(best[2]),
                "best_epoch": int(best[3]),
            },
            "best_state": _state_dict(best[0]),
        })

    def run_epoch(epoch: int) -> torch.Tensor:
        """One step and the stopping eval; the epoch's three scalars, on
        the device (read back by the caller once this frame's tensors
        are freed, while the device still runs the eval)."""
        loss, grads = loss_and_grads(
            model, x, propagator, idx_train, y_train,
            key=prng.fold_in(key_epochs, epoch), drop_prob=drop_prob,
            reg_lambda=reg_lambda)
        with annotate("ppnp/optimizer"):
            optimizer.step(grads)
        with torch.no_grad(), annotate("ppnp/eval"):
            logp = ppnp_forward(model, x, propagator, idx_stop, train=False)
            stop_loss = _nll(logp, y_stop)
            stop_acc = _mean((logp.argmax(dim=-1) == y_stop).float())
            return torch.stack([loss.detach(), stop_acc, stop_loss])

    last_epoch = max(start_epoch - 1, 0)
    stop = False
    chunk_start = start_epoch
    # Per-chunk (n_epochs, wall_s) pairs
    chunk_times: list = []
    tracing = contextlib.ExitStack()
    traced = False
    while chunk_start < max_epochs and not stop:
        if (profile_dir is not None and not traced
                and (chunk_times or max_epochs - start_epoch
                     <= epoch_chunk)):
            tracing.enter_context(trace(profile_dir,
                                        create_perfetto_trace=True))
            traced = True
        t_chunk = time.perf_counter()
        count = min(epoch_chunk, max_epochs - chunk_start)
        for epoch in range(chunk_start, chunk_start + count):
            with annotate("ppnp/epoch"):
                scalars = run_epoch(epoch)
                with annotate("ppnp/readback"):
                    # one device-to-host copy for the epoch's three scalars
                    loss, acc, stop_loss = scalars.tolist()
                with annotate("ppnp/bookkeeping"):
                    last_epoch = epoch
                    if not np.isfinite(loss):
                        tracing.close()
                        raise FloatingPointError(
                            f"non-finite training loss at epoch {epoch} "
                            f"(loss={loss}); check learning rate / inputs")
                    if acc > best[1] or (acc == best[1]
                                         and stop_loss < best[2]):
                        best = (_snapshot(model), acc, stop_loss, epoch)
                    stop = early_stopping.check([acc, stop_loss], epoch)
            if metrics is not None:
                with annotate("ppnp/metrics"):
                    metrics.write(event="epoch", epoch=epoch,
                                  train_loss=loss, stopping_accuracy=acc,
                                  stopping_loss=stop_loss)
            if print_interval and epoch % print_interval == 0:
                log(
                    "epoch %4d: train loss %.4f, stopping acc %.4f "
                    "loss %.4f", epoch, loss, acc, stop_loss)
            if stop:
                break
        chunk_times.append((last_epoch - chunk_start + 1,
                            time.perf_counter() - t_chunk))
        if checkpoint_dir is not None and (
                stop or (chunk_start // checkpoint_every)
                != ((last_epoch + 1) // checkpoint_every)):
            _save(last_epoch)
        chunk_start += count

    if checkpoint_dir is not None and not stop:
        # max_epochs ran out without an early stop: persist the final state
        _save(last_epoch)
    tracing.close()
    if traced:
        log("profiler trace written to %s", profile_dir)

    runtime = time.time() - t_start
    best_weights, _, _, best_epoch = best
    if best_epoch >= 0:
        with torch.no_grad():  # restore the best snapshot
            for w, b in zip(params, best_weights):
                w.copy_(b)
    else:
        best_epoch = None

    if profile_dir is not None and not traced and chunk_times:
        logger.warning(
            "training ended during the first epoch chunk; tracing the "
            "final eval forward instead of steady-state chunks")
        with trace(profile_dir, create_perfetto_trace=True):
            preds = get_predictions(model, x, propagator)
    else:
        preds = get_predictions(model, x, propagator)
    result: Dict[str, Any] = {}
    for split_name, idx in (("train", idx_train_np),
                            ("early_stopping", idx_stop_np),
                            ("valtest", idx_valtest_np)):
        result[split_name] = {
            "accuracy": accuracy(labels_np[idx], preds[idx]),
            "f1_score": macro_f1(labels_np[idx], preds[idx], n_classes),
        }
    nepochs = last_epoch + 1
    result.update(
        x_format="sparse" if isinstance(x, SparseInput) else "dense",
        runtime=runtime,
        runtime_perepoch=runtime / max(nepochs, 1),
        chunk_times=chunk_times,
        last_epoch=last_epoch,
        best_epoch=best_epoch,
        predictions=preds,
    )
    if metrics is not None:
        metrics.write(event="final", **{
            k: v for k, v in result.items() if k != "predictions"})
    log("done: %d epochs (best %s), valtest acc %.4f f1 %.4f, %.1fs",
        nepochs, best_epoch,
        result["valtest"]["accuracy"], result["valtest"]["f1_score"],
        runtime)
    return model, result
