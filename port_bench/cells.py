"""Finds a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each part is a file of its own, found by name, so that a later change adds a
configuration, a traffic mix, a cell's limits or a per-layer metric as new
files plus an entry, with no edit to code:

* ``configs`` entries give their ``file`` (a JSON object of the program's
  flags, plus the keys in :data:`META_KEYS`);
* ``traffic/<traffic>.json``: the loop (``kind``), its parameters, and
  ``flags`` that override the configuration's (the batch of a cell);
* ``limits/<workload>.json``: the limit of each number the correctness
  check compares;
* ``metrics/<metric>.py``: a per-layer metric's reader, a module with
  ``read(run) -> float | None``; its entry lists the cells it is read in
  (``workloads``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
# keys of a configuration file that are not flags of the program
META_KEYS = ("name", "source", "assumed", "published", "notes", "deployment")


def load_benchmark(root: Path | None = None) -> dict:
    return json.loads(((root or PKG.parent) / "BENCHMARK.json").read_text())


def flags_of(config: dict) -> dict:
    """The program's flags in a configuration file."""
    return {k: v for k, v in config.items() if k not in META_KEYS}


def argv_of(flags: dict) -> list:
    """``--name value`` for every flag; booleans as ``true`` / ``false``."""
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", ("true" if v else "false") if isinstance(v, bool) else str(v)]
    return argv


def find_cell(name: str, root: Path | None = None, pkg: Path | None = None) -> dict:
    """Everything a run of cell ``name`` needs → {workload, config (the
    file), flags (config's, traffic's on top), traffic, limits, end_to_end
    (metric entries), per_layer (entries with their ``reader``),
    run_seconds, where (the arguments that find it again)}. Raises
    KeyError / FileNotFoundError naming what is missing."""
    root = root or PKG.parent
    pkg = pkg or root / "port_bench"
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((pkg / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((pkg / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    per_layer = []
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no workloads")
        if name in m["workloads"]:
            per_layer.append({**m, "reader": load_reader(pkg / "metrics" / f"{m['name']}.py")})
    flags = {**flags_of(config), **traffic.get("flags", {})}
    return {"workload": cell, "config": config, "flags": flags, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"], "where": (name, root, pkg)}


def load_reader(path: Path):
    """The ``read`` function of a per-layer metric's module."""
    if not path.exists():
        raise FileNotFoundError(f"per-layer metric reader {path} is missing")
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
