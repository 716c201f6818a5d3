"""The port's public surface against the JAX package's.

- Every name a JAX ``__init__`` re-exports (but the pair-chunk names,
  which the port does not keep) is re-exported by the port's counterpart
  package, and is the object its module defines; importing the packages
  builds, loads and launches nothing.
- ``ops.spmm`` on its xla arm and its pallas arm (on the CPU the plain
  K1; JAX's Pallas kernel in interpret mode at the reduced geometry)
  against JAX's ``spmm`` within 1e-5, and its error cases.
- ``edge_list_from_scipy(..., nnz_pad=N)``, ``build_sparse_input`` (with
  and without ``n_rows``) and ``networkx_to_sparsegraph`` against JAX's:
  arrays equal, the sparse fc1 within 1e-5, every graph field bit-equal.
"""

import ast
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppnp_tpu.data.io import networkx_to_sparsegraph as j_nx_to_graph
from ppnp_tpu.ops.normalize import calc_A_hat
from ppnp_tpu.ops.pairchunks import _slot_coords, pair_chunks_banded
from ppnp_tpu.ops.propagation import spmm as j_spmm
from ppnp_tpu.ops.sparse import edge_list_from_scipy as j_edge_list
from ppnp_tpu.ops.sparse_input import build_sparse_input as j_build_input
from ppnp_tpu.preprocessing import normalize_attributes

from ppnp_tpu_torch.data.io import networkx_to_sparsegraph
from ppnp_tpu_torch.ops import (csr_from_scipy, edge_list_from_scipy,
                                rcm_permutation, spmm)
from ppnp_tpu_torch.ops import prng
from ppnp_tpu_torch.ops.sparse_input import build_sparse_input

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
GEO = dict(window=128, window_src=128, chunk=8, seg_per_mid=8,
           mids_per_step=4)
# the JAX packages whose __init__ re-exports names, and the pair-chunk
# names the port leaves out (ROADMAP "Not to port")
PACKAGES = ("", ".data", ".ops", ".models", ".parallel", ".kernels")
PAIR_CHUNKS = {"PairChunks", "pair_chunks_auto", "pair_chunks_banded",
               "pair_chunks_from_scipy", "select_geometry",
               "validate_pair_chunks", "BlockedPairChunks",
               "build_blocked_pair_chunks", "spmm_pair_chunks"}
# the port's counterparts of the pair-chunk builders, re-exported beside
# the JAX names
CSR_NAMES = {"CsrMatrix": "sparse", "csr_from_scipy": "sparse",
             "csr_transpose": "sparse", "rcm_permutation": "sparse"}


def _jax_reexports(package: str):
    """(name, defining module) of each name a JAX ``__init__`` imports,
    read from its source."""
    path = ROOT / "ppnp_tpu" / Path(*package.split(".")) / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                yield alias.name, node.module


@pytest.mark.parametrize("package", PACKAGES)
def test_every_jax_reexport_has_its_counterpart(package):
    port = importlib.import_module("ppnp_tpu_torch" + package)
    names = [(n, m) for n, m in _jax_reexports(package)
             if n not in PAIR_CHUNKS]
    assert names
    if package == ".ops":
        names += [(n, f"ppnp_tpu.ops.{m}") for n, m in CSR_NAMES.items()]
        # the backend-dispatching SpMM of the JAX module's __all__
        names.append(("spmm", "ppnp_tpu.ops.propagation"))
    for name, module in names:
        home = importlib.import_module(
            module.replace("ppnp_tpu", "ppnp_tpu_torch", 1))
        assert getattr(port, name) is getattr(home, name), (package, name)
        assert name in getattr(home, "__all__", [name]), (module, name)
    if hasattr(port, "__all__"):
        assert {n for n, _ in names} <= set(port.__all__)


_IMPORT_PACKAGES = textwrap.dedent("""
    import sys
    import torch.distributed as dist
    import ppnp_tpu_torch, ppnp_tpu_torch.ops, ppnp_tpu_torch.models
    import ppnp_tpu_torch.parallel, ppnp_tpu_torch.kernels
    from ppnp_tpu_torch.kernels import build
    from ppnp_tpu_torch.ops import spmm, PPRPowerIteration, PPRExact
    from ppnp_tpu_torch.kernels import spmm_blocked
    assert not any(build.LAUNCHES.values()), build.LAUNCHES
    assert not build._libs, build._libs
    assert not dist.is_initialized()
    with open("/proc/self/maps") as f:
        assert "ppnp_tpu_torch/lib" not in f.read()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "ppnp_tpu")]
    assert not bad, bad
""")


def test_importing_the_packages_builds_and_starts_nothing():
    """In a fresh process: no launch counted, no kernel library loaded or
    mapped, no process group, no jax."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_PACKAGES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.fixture(scope="module")
def a_hat(small_graph):
    return calc_A_hat(small_graph.adj_matrix)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_spmm_matches_jax(a_hat, backend):
    """Â @ H in the caller's row order on both arms, against JAX's arm of
    the same name; the xla arm also with the weights overridden."""
    rng = np.random.RandomState(3)
    h = rng.randn(a_hat.shape[0], 16).astype(np.float32)
    w = rng.rand(j_edge_list(a_hat).nnz_pad).astype(np.float32)
    edges = edge_list_from_scipy(a_hat, device=CPU)
    csr = pc = None
    if backend == "pallas":
        csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
        pc = pair_chunks_banded(a_hat, reorder="rcm", use_native="never",
                                **GEO)
    got = spmm(edges, torch.from_numpy(h), csr=csr, backend=backend)
    want = j_spmm(j_edge_list(a_hat), jnp.asarray(h), pair_chunks=pc,
                  backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if backend == "xla":
        got = spmm(edges, torch.from_numpy(h), torch.from_numpy(w))
        want = j_spmm(j_edge_list(a_hat), jnp.asarray(h), jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spmm_refuses_what_jax_refuses(a_hat):
    edges = edge_list_from_scipy(a_hat, device=CPU)
    csr = csr_from_scipy(a_hat, perm=rcm_permutation(a_hat), device=CPU)
    h = torch.zeros(a_hat.shape[0], 4)
    with pytest.raises(ValueError, match="pallas backend requires"):
        spmm(edges, h, backend="pallas")
    with pytest.raises(ValueError, match="pallas backend requires"):
        j_spmm(j_edge_list(a_hat), jnp.zeros((a_hat.shape[0], 4)),
               backend="pallas")
    with pytest.raises(ValueError, match="pallas backend takes per-iter"):
        spmm(edges, h, edges.w, csr=csr, backend="pallas")
    with pytest.raises(ValueError, match="pallas backend takes per-iter"):
        j_spmm(j_edge_list(a_hat), jnp.zeros((a_hat.shape[0], 4)),
               jnp.zeros(j_edge_list(a_hat).nnz_pad), pair_chunks=object(),
               backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        spmm(edges, h, csr=csr, backend="fused")


@pytest.mark.parametrize("extra", [None, 0, 37, 1024])
def test_edge_list_nnz_pad_matches_jax(a_hat, extra):
    """``nnz_pad`` (None: rounded up to 512) gives JAX's arrays and
    counts; below nnz both raise."""
    nnz_pad = None if extra is None else a_hat.nnz + extra
    got = edge_list_from_scipy(a_hat, nnz_pad, device=CPU)
    want = j_edge_list(a_hat, nnz_pad)
    for name in ("dst", "src", "w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert (got.n_rows, got.n_cols, got.nnz) == (want.n_rows, want.n_cols,
                                                 want.nnz)
    with pytest.raises(ValueError, match="nnz_pad"):
        edge_list_from_scipy(a_hat, a_hat.nnz - 1, device=CPU)
    with pytest.raises(ValueError, match="nnz_pad"):
        j_edge_list(a_hat, a_hat.nnz - 1)


def test_edge_list_defaults_to_the_card(a_hat, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_list_from_scipy(a_hat)


def _unpack(pc, n_rows, n_cols):
    """The dense matrix a JAX packing holds."""
    rows, cols, valid = _slot_coords(pc)
    w = np.asarray(pc.e_w).T.reshape(-1)
    dense = np.zeros((pc.n_rows_pad, pc.n_cols_pad), np.float32)
    np.add.at(dense, (rows[valid], cols[valid]), w[valid])
    return dense[:n_rows, :n_cols]


def _dense(csr):
    return sp.csr_matrix((csr.val.numpy(), csr.col.numpy(),
                          csr.row_ptr.numpy()),
                         shape=(csr.n_rows, csr.n_cols)).toarray()


@pytest.mark.parametrize("n_rows", [None, 431])
def test_build_sparse_input_matches_jax(small_graph, n_rows):
    """X and Xᵀ equal to JAX's packings unpacked (padded rows empty), and
    fc1 in eval and train mode (the same id-keyed mask) within 1e-5."""
    attr = normalize_attributes(small_graph.attr_matrix)
    n, f = attr.shape
    got = build_sparse_input(attr, n_rows, device=CPU)
    want = j_build_input(attr, n_rows)
    rows = n_rows or n
    assert got.shape == want.shape == (rows, f)
    x = _unpack(want.pc, rows, f)
    np.testing.assert_array_equal(_dense(got.csr), x)
    np.testing.assert_array_equal(_dense(got.csr_t), _unpack(want.pc_t, f,
                                                             rows))
    assert not x[n:].any()
    w = np.random.RandomState(5).randn(f, 16).astype(np.float32)
    for train in (False, True):
        out = got.matmul(torch.from_numpy(w), key=prng.PRNGKey(9),
                         train=train)
        ref = want.matmul(jnp.asarray(w), key=jax.random.PRNGKey(9),
                          train=train)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="n_rows"):
        build_sparse_input(attr, n - 1, device=CPU)


def _nx_graph(names: bool):
    """The graph of ``test_sparsegraph.py::test_networkx_converter``;
    with ``names``, string node names, an int attribute some nodes lack
    and a node without a label."""
    nx = pytest.importorskip("networkx")
    g = nx.Graph()
    g.add_edges_from([(0, 1), (1, 2), (2, 0), (2, 3)])
    for u in g.nodes:
        g.nodes[u]["weight_attr"] = float(u)
        g.nodes[u]["cls"] = "a" if u % 2 == 0 else "b"
    if names:
        g = nx.relabel_nodes(g, {u: f"n{u}" for u in g.nodes})
        g.add_edge("n3", "n4")
        g.nodes["n1"]["count"] = 7
        g.nodes["n4"]["weight_attr"] = 2.5
    return g


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if sp.issparse(a):
        return (sp.issparse(b) and a.shape == b.shape and a.dtype == b.dtype
                and all(np.array_equal(getattr(a, k), getattr(b, k))
                        for k in ("data", "indices", "indptr")))
    return (type(a) is type(b) and a.dtype == b.dtype
            and np.array_equal(a, b))


@pytest.mark.parametrize("names", [False, True])
@pytest.mark.parametrize("sparse_attrs", [True, False])
@pytest.mark.parametrize("label_name", ["cls", None])
def test_networkx_to_sparsegraph_is_bit_equal(names, sparse_attrs,
                                              label_name):
    g = _nx_graph(names)
    got = networkx_to_sparsegraph(g, label_name=label_name,
                                  sparse_node_attrs=sparse_attrs)
    want = j_nx_to_graph(g, label_name=label_name,
                         sparse_node_attrs=sparse_attrs)
    for field in ("adj_matrix", "attr_matrix", "labels", "node_names",
                  "attr_names", "class_names"):
        assert _same(getattr(got, field), getattr(want, field)), field
    assert got.metadata == want.metadata
    assert sp.issparse(got.attr_matrix) == sparse_attrs


def test_console_script_names_the_cli():
    """``ppnp-tpu-torch`` runs the port's CLI, beside JAX's ``ppnp-tpu``."""
    import tomllib

    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["ppnp-tpu"] == "ppnp_tpu.__main__:main"
    module, func = scripts["ppnp-tpu-torch"].split(":")
    from ppnp_tpu_torch.__main__ import main
    assert getattr(importlib.import_module(module), func) is main
