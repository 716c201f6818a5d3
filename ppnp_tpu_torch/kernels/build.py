"""Build, load and count the port's CUDA kernels.

Each source in ``ppnp_tpu_torch/csrc`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. Nothing happens at import: the first call of a
kernel wrapper on a CUDA tensor builds what it needs, and
``build_kernels()`` builds every source at once, one ``nvcc`` process per
source, all started together. Libraries go to ``<repo>/build/
ppnp_tpu_torch/`` under a name that hashes the sources and flags, so an
edited source is never served by a stale build.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: a wrapper
adds one right after its kernel was launched without error, and nowhere
else, so a run can show that the main path went through the kernels. It
counts wrapper calls: a launch captured into a CUDA graph counts once,
and a replay of the graph adds nothing (``train.get_predictions`` and
its ``REQUEST_GRAPHS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "NVCC_FLAGS", "LAUNCHES", "reset_launches",
           "build_kernels", "load_library", "check_error"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppnp_tpu_torch"

# library name -> source file in csrc/ (each includes common.cuh)
SOURCES = {"spmm": "spmm.cu", "fused": "fused.cu", "masks": "masks.cu"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _L = ctypes.c_uint, ctypes.c_longlong
# row_ptr, col, e_w_all; n_planes, nnz; h0, out, tmp; n, c; alpha; niter;
# sync; sync_words; info; device; stream
_FUSED_ARGS = [_P] * 3 + [_I] * 2 + [_P] * 3 + [_I] * 2 + [_F] + [_I] \
    + [_P] + [_I] + [_P] + [_I] + [_P]
# library name -> {launch function: its argument types}; each returns a
# CUDA error code
_ENTRY = {
    # K1 and K2: row_ptr, col, w_g, h, init, out; n_rows, groups, cg,
    # nnz, device; stream
    "spmm": {"ppnp_grouped_spmm_csr": [_P] * 6 + [_I] * 5 + [_P],
             # n_rows, groups, cg; h, init, shape (5 ints out); returns 0
             "ppnp_grouped_spmm_shape": [_I] * 3 + [_P] * 3},
    "fused": {"ppnp_appnp_fused": _FUSED_ARGS,
              "ppnp_appnp_adjoint": _FUSED_ARGS},
    "masks": {
        # rows, col, val, out; nnz, transposed; span; pos, val_t, out_t,
        # bits, keys; n_keys; thresh; keep, scale; device; stream
        "ppnp_edge_masks": [_P] * 4 + [_I] * 2 + [_L] + [_P] * 5
        + [_I, _U, _F, _F, _I, _P],
        # keys, n_keys, n_rows, last, thresh, word_offset, mask, device,
        # stream
        "ppnp_dropout_masks": [_P, _I, _L, _I, _U, _L, _P, _I, _P],
    },
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# K1 forward and backward (on the transpose), K2 forward and backward, K3
# forward and adjoint, the id-keyed edge masks and the dense dropout mask
LAUNCHES: Dict[str, int] = {"spmm_csr": 0, "spmm_csr_bwd": 0,
                            "spmm_grouped": 0, "spmm_grouped_bwd": 0,
                            "appnp_fused": 0, "appnp_adjoint": 0,
                            "edge_masks": 0, "dropout_mask": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on the card's "
                           "machine")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], "common.cuh"):
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels(names=None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are not built yet.

    Starts one ``nvcc`` per source, all at once, and waits for them.
    Returns ``{name: compiler output}`` for the sources it compiled (the
    ``-Xptxas -v`` register and shared-memory report). Raises with the
    compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with the
    argument and result types of its functions declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.ppnp_error_string.argtypes = [ctypes.c_int]
            lib.ppnp_error_string.restype = ctypes.c_char_p
            for fn_name, argtypes in _ENTRY[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.ppnp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

