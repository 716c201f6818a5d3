"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry in ``configs`` gives;
- a traffic mix: ``traffic/<traffic>.json``, whose ``entry`` names the
  program's function the window drives (``ENTRIES`` gives the kind of
  cell each makes) and whose ``edge_ids`` names the coordinates the
  backend keys its edge masks by (``rcm``, ``blocked`` or ``sharded``,
  which the reference works out again; ``reference.prepare``); with
  ``"propagation": "sharded"`` the call runs row-sharded over the cell's
  ``chips`` ranks (``ranks.py``);
- a cell's limits for ``correct``: ``limits/<workload>.json``;
- a per-layer metric: the reader ``metrics/<name>.py``, else
  ``metrics/<name up to its first dot>.py`` (one reader serves
  ``mfu.train``, ``mfu.sweep`` and ``mfu.serve``), whose ``read(run)``
  returns a number or None when it finds nothing to read;
- a configuration's reference: the module its file's top-level
  ``"reference"`` names (a path from the checkout's root, under the
  benchmark's directory, such as ``portbench/references/<name>.py``),
  else ``portbench/reference.py``; its interface is in that module's
  docstring.

A configuration's ``model`` block chooses the model: ``"propagation"``
is ``"power"`` (APPNP's K steps, the default; ``niter`` required) or
``"exact"`` (PPNP's dense Π; no ``niter``). How a mix runs across ranks
(``"propagation": "sharded"``) is the traffic file's.

A later change adds a configuration, a mix, a cell, a metric or a
reference by adding such files and entries; no file here needs an edit
for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

__all__ = ["Bench", "validate", "validate_config", "ENTRIES", "kind_of",
           "BANNED", "banned_modules"]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# top-level modules that must not be loaded in a run of the port
BANNED = ("jax", "jaxlib", "flax", "ppnp_tpu")
# a traffic mix's ``entry`` -> the kind of cell it drives
ENTRIES = {"train_model": "train", "train_models": "sweep",
           "get_predictions": "serve"}
# a configuration's ``model.propagation``: the model it runs
PROPAGATIONS = ("power", "exact")


def banned_modules() -> List[str]:
    """The banned top-level modules loaded in this process, compared by
    whole top-level names."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def kind_of(traffic: Dict) -> str:
    """``train``, ``sweep`` or ``serve``: what the mix's entry drives."""
    return ENTRIES[traffic["entry"]]


class Bench:
    """The benchmark rooted at ``root`` (the checkout holding
    ``BENCHMARK.json``), its files under ``pkg`` (default
    ``root/portbench``)."""

    def __init__(self, root, pkg=None):
        self.root = Path(root)
        self.pkg = Path(pkg) if pkg is not None else self.root / "portbench"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                bad = validate_config(cfg)
                if bad:
                    raise ValueError(f"configuration {name!r}: "
                                     + "; ".join(bad))
                return cfg
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def reference(self, cfg: Dict) -> ModuleType:
        """The reference module of a loaded configuration: the file its
        ``"reference"`` names, loaded by path, else
        ``portbench.reference``."""
        if "reference" not in cfg:
            from portbench import reference
            return reference
        path = (self.root / cfg["reference"]).resolve()
        if not path.is_relative_to(self.pkg.resolve()):
            raise ValueError(f"reference {cfg['reference']!r} lies outside "
                             f"{self.pkg}")
        name = "portbench_reference_" + re.sub(r"\W", "_", str(path))
        if name not in sys.modules:
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod  # a dataclass there looks itself up
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                del sys.modules[name]
                raise
        return sys.modules[name]

    def traffic(self, name: str) -> Dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        return json.loads((self.pkg / "limits" / f"{workload}.json")
                          .read_text())

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in moved)]

    def reader(self, metric: str) -> Callable:
        for stem in (metric, metric.split(".")[0]):
            path = self.pkg / "metrics" / f"{stem}.py"
            if path.exists():
                spec = importlib.util.spec_from_file_location(
                    f"portbench_metric_{stem.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r} "
                                f"under {self.pkg / 'metrics'}")


def validate_config(cfg: Dict) -> List[str]:
    """What in a configuration file breaks the rules the harness reads
    it by: its model's ``propagation``, ``niter`` where the model runs K
    steps, and its ``reference``'s path."""
    bad: List[str] = []
    model = cfg.get("model", {})
    prop = model.get("propagation", "power")
    if prop not in PROPAGATIONS:
        bad.append(f"model.propagation {prop!r} is not one of "
                   f"{PROPAGATIONS}")
    elif prop == "power" and "niter" not in model:
        bad.append("model.niter is required unless model.propagation is "
                   "'exact'")
    ref = cfg.get("reference")
    if ref is not None and not (
            isinstance(ref, str) and PATH.match(ref) and ref.endswith(".py")
            and ".." not in ref.split("/") and not ref.startswith("/")):
        bad.append(f"reference {ref!r} is not a relative path to a .py file")
    return bad


def validate(doc: Dict) -> List[str]:
    """What in a ``BENCHMARK.json`` breaks the contract's lexical and
    structural rules (names, units, lines, keys, references)."""
    bad: List[str] = []

    def need(ok, what):
        if not ok:
            bad.append(what)

    need(set(doc) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}, "top keys")
    need(1 <= len(doc["paths"]) <= 16
         and all(PATH.match(p) and ".." not in p.split("/")
                 and not p.startswith("/") for p in doc["paths"]), "paths")
    need(len(doc["command"]) <= 32
         and all(LINE.match(w) for w in doc["command"]), "command")
    need(isinstance(doc["run_seconds"], int)
         and 1 <= doc["run_seconds"] <= 51, "run_seconds")
    configs = {c["name"] for c in doc["configs"]}
    for c in doc["configs"]:
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config keys {c['name']}")
        need(NAME.match(c["name"]) and LINE.match(c["source"])
             and LINE.match(c["why"]), f"config {c['name']}")
        need(len(c["reduced"]) <= 16
             and all(NAME.match(k) for k in c["reduced"]),
             f"reduced {c['name']}")
        need(any(c["file"].startswith(p.rstrip("/") + "/")
                 for p in doc["paths"]), f"config file {c['name']}")
    four = sum(w.get("chips") == 4 for w in doc["workloads"])
    need(four <= max(1, len(doc["workloads"]) // 4), "four-chip cells")
    cells = set()
    for w in doc["workloads"]:
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"workload keys {w['name']}")
        need(NAME.match(w["name"]) and NAME.match(w["traffic"])
             and w["config"] in configs and w["chips"] in (1, 4)
             and LINE.match(w["why"]), f"workload {w['name']}")
        need((w["config"], w["traffic"]) not in cells,
             f"pair {w['name']}")
        cells.add((w["config"], w["traffic"]))
    names = set()
    e2e = {m["name"] for m in doc["end_to_end"]}
    need("setup_s" in e2e, "setup_s")
    for kind in ("end_to_end", "per_layer"):
        for m in doc[kind]:
            keys = ({"name", "unit", "better", "bound", "source"}
                    if kind == "end_to_end" else
                    {"name", "unit", "better", "source", "layer", "moves"})
            need(set(m) - {"workloads"} == keys, f"metric keys {m['name']}")
            need(NAME.match(m["name"]) and UNIT.match(m["unit"])
                 and m["better"] in ("lower", "higher")
                 and m["source"] in SOURCES, f"metric {m['name']}")
            need(m["name"] not in names, f"duplicate {m['name']}")
            names.add(m["name"])
            need(set(m.get("workloads", [])) <= {w["name"] for w in
                                                 doc["workloads"]},
                 f"metric workloads {m['name']}")
            if kind == "end_to_end":
                need(0.01 <= m["bound"] <= 0.25
                     and m["source"] in ("host_clock", "device_trace"),
                     f"bound {m['name']}")
            else:
                need(LINE.match(m["layer"]) and m["moves"] in e2e,
                     f"layer {m['name']}")
    return bad
