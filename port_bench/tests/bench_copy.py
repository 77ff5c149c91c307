"""A temporary copy of the benchmark with a small cell added as data files
only (a configuration, a traffic mix, the cell's limits), for the CPU tests.

The small cell keeps the configuration's widths (8x256, Lx = 10, Ld = 4;
the hash grid's 16 levels x 2 features) and cuts what a CPU run cannot
carry: the rays, the samples, the scene (4 views of 32x32) and the hash
tables' rows.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {"rays_per_batch": 64, "nc": 16, "nf": 16, "eval_chunk": 512}
SMALL_HASH = {"hash_log2_size": 12, "hash_max_res": 256}
SCENE = {"views": 4, "height": 32, "width": 32}


def make_copy(tmp: Path, *, kind: str = "train", config: str = "nerf-vanilla-blender",
              limits_of: str = "vanilla-train", flags: dict | None = None,
              name: str = "small-cell") -> Path:
    """Copy ``BENCHMARK.json`` and ``port_bench/`` (its code, data and
    readers, no cache) under ``tmp`` and add cell ``name``: ``config`` cut
    as :data:`SMALL`, a ``kind`` traffic mix on the small scene, the limits
    of cell ``limits_of``, and the small cell listed under every per-layer
    metric that lists ``limits_of``. → the copy's root."""
    root = tmp / "bench"
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = root / "port_bench"
    cfg = json.loads((REPO / [c["file"] for c in bench["configs"]
                              if c["name"] == config][0]).read_text())
    cfg.update(SMALL)
    if cfg.get("encoder") == "hashgrid":
        cfg.update(SMALL_HASH)
    cfg.update(flags or {})
    cfg["name"] = f"{name}-config"
    (pkg / "configs" / f"{name}-config.json").write_text(json.dumps(cfg))
    traffic = ({"kind": "train", "scan_steps": 2, "trace_seconds": 1, "scene": SCENE}
               if kind == "train" else
               {"kind": "render", "path_frames": 3, "check_pixels": 256,
                "trace_seconds": 1, "scene": SCENE})
    (pkg / "traffic" / f"{name}-traffic.json").write_text(json.dumps(traffic))
    shutil.copy(pkg / "limits" / f"{limits_of}.json", pkg / "limits" / f"{name}.json")
    bench["configs"].append({"name": f"{name}-config", "source": "https://arxiv.org/abs/2003.08934",
                             "file": f"port_bench/configs/{name}-config.json",
                             "reduced": ["rays_per_batch", "nc", "nf"], "why": "CPU test"})
    bench["workloads"].append({"name": name, "config": f"{name}-config",
                               "traffic": f"{name}-traffic", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if limits_of in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
