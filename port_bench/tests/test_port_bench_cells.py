"""The benchmark's cells resolve to their files, a cell added as data files
is found with no edit to code, and the configurations give the program the
run they name (CPU only)."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from port_bench import cells
from port_bench.tests.bench_copy import REPO, make_copy


def test_every_cell_resolves():
    bench = cells.load_benchmark()
    assert bench["command"][:3] == ["python3", "-m", "port_bench.run"]
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"])
        assert cell["traffic"]["kind"] in ("train", "render")
        assert cell["limits"], w["name"]
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell["per_layer"], w["name"]
        assert all(callable(m["reader"]) for m in cell["per_layer"])


def test_benchmark_file_keeps_the_contract_shape():
    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["workloads"], m["name"]
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
        assert c["file"].startswith("port_bench/")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for item in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert name.match(item["name"]), item["name"]
        texts = [item[k] for k in ("why", "layer") if k in item]
        if "file" in item:                       # a configuration's source
            texts.append(item["source"])
        for text in texts:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, item
        if "unit" in item:
            assert unit.match(item["unit"]), item["unit"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_cell_added_as_data_is_found(tmp_path):
    root = make_copy(tmp_path)
    pkg = root / "port_bench"
    (pkg / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return run['counts'].get('steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_samples_per_s", "workloads": ["small-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.find_cell("small-cell", root=root)
    assert cell["flags"]["rays_per_batch"] == 64
    assert cell["traffic"]["scan_steps"] == 2
    readers = {m["name"]: m["reader"] for m in cell["per_layer"]}
    assert readers["steps_traced"]({"counts": {"steps": 32}}) == 32
    assert "mfu.train" in readers and "k2_roofline" not in readers


def test_a_missing_part_is_named(tmp_path):
    root = make_copy(tmp_path)
    (root / "port_bench" / "limits" / "small-cell.json").unlink()
    with pytest.raises(FileNotFoundError):
        cells.find_cell("small-cell", root=root)
    with pytest.raises(KeyError):
        cells.find_cell("no-such-cell", root=root)


def test_a_per_layer_metric_without_its_cells_is_refused(tmp_path):
    """A per-layer entry names the cells it is read in: one with no
    ``workloads`` stops every cell's lookup, naming the metric."""
    root = make_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError, match=bench["per_layer"][0]["name"]):
        cells.find_cell("small-cell", root=root)


@pytest.mark.parametrize("config", ["nerf-vanilla-blender", "ngp-hashgrid-blender"])
def test_config_flags_are_the_vanilla_profile(config):
    """The flags written out give the Config that ``--vanilla`` gives (the
    hash grid's own flags on top), except the ``vanilla`` switch itself."""
    from nerf_sandbox_tpu_torch.scripts.train_nerf import resolve_config
    bench = cells.load_benchmark()
    path = REPO / [c["file"] for c in bench["configs"] if c["name"] == config][0]
    flags = cells.flags_of(json.loads(path.read_text()))
    base = ["--data_root", "/nowhere", "--out_dir", "/nowhere", "--data_kind", "blender"]
    written = dataclasses.asdict(resolve_config(base + cells.argv_of(flags)))
    extra = {k: v for k, v in flags.items()
             if k.startswith("hash_") or k in ("encoder", "lr_grid")}
    profile = dataclasses.asdict(resolve_config(
        base + ["--vanilla", "--near_world", "2", "--far_world", "6", "--val_split", "train"]
        + cells.argv_of(extra)))
    diff = {k for k in written if written[k] != profile[k]}
    assert diff == {"vanilla"}
