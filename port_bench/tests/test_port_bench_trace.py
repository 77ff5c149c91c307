"""The trace reader and the per-layer readers on a synthetic trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from port_bench import arith, cells, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start_us, dur_us, dev):
        self._n, self._s, self._d, self._dev = name, int(start_us * 1000), int(dur_us * 1000), dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def device_index(self):
        return 0

    def is_user_annotation(self):
        return self._n.startswith("port_bench.")


def fake_prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


def test_busy_idle_and_breakdown():
    events = [Event("port_bench.window", 0, 1000, CPU),
              Event("port_bench.chunk", 0, 900, CPU),
              Event("cudaStreamSynchronize", 600, 300, CPU),
              Event("gemm", 10, 100, CUDA), Event("gemm", 50, 100, CUDA),   # overlap
              Event("hash_scatter_sum<2>", 200, 300, CUDA),
              Event("before", -50, 20, CUDA),                                # outside
              Event("relu", 505, 5, CUDA),
              Event("port_bench.chunk", 0, 900, CUDA)]                     # a span's image
    tr = trace.Trace(fake_prof(events), "port_bench.window")
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx((140 + 300 + 5) * 1e-6)
    assert tr.device_seconds(lambda n: "hash_scatter_" in n) == pytest.approx(300e-6)
    assert tr.device_ops()[0] == ["hash_scatter_sum<2>", pytest.approx(300e-6)]
    gaps = dict(tr.idle_gaps())
    # each gap of 20 us or more named by the innermost host op at its middle
    assert gaps["cudaStreamSynchronize"] == pytest.approx(490e-6)      # 510..1000
    assert gaps["port_bench.chunk"] == pytest.approx(50e-6)            # 150..200
    assert gaps["gaps under 20 us"] == pytest.approx(10e-6 + 5e-6)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_a_trace_without_the_card_fails():
    with pytest.raises(RuntimeError):
        trace.Trace(fake_prof([Event("port_bench.window", 0, 10, CPU)]), "port_bench.window")


def readers():
    bench = cells.load_benchmark()
    return {m["name"]: cells.load_reader(cells.PKG / "metrics" / f"{m['name']}.py")
            for m in bench["per_layer"]}


def test_readers_on_a_synthetic_trace():
    events = [Event("port_bench.window", 0, 1_000_000, CPU),
              Event("void fused_raymarch_kernel<0, false, 256>(MarchArgs)", 0, 200_000, CUDA),
              Event("hash_scatter_partition", 300_000, 100_000, CUDA),
              Event("ncclDevKernel_AllReduce_Sum_f32", 500_000, 1000, CUDA)]
    tr = trace.Trace(fake_prof(events), "port_bench.window")
    cfg = {"rays_per_batch": 1024, "nc": 64, "nf": 128, "n_layers": 8, "hidden_dim": 256,
           "skip_pos": 4, "pos_num_freqs": 10, "dir_num_freqs": 4, "encoder": "hashgrid",
           "hash_levels": 16, "hash_features": 2, "hash_log2_size": 19}
    run = {"trace": tr, "settings": cfg, "arith": arith, "window_s": 1.0,
           "scene": {"height": 800, "width": 800},
           "counts": {"steps": 16, "world": 1, "frames": 1}}
    r = readers()
    assert r["idle_pct.train"](run) == pytest.approx(100 * (1 - 0.301))
    assert r["hash_scatter_share_pct"](run) == pytest.approx(10.0)
    assert r["hash_scatter_roofline"](run) == pytest.approx(
        100 * 16 * arith.hash_scatter_bytes_per_step(cfg) / 3.35e12 / 0.1)
    assert r["mfu.train"](run) == pytest.approx(
        100 * 16 * arith.train_flops_per_step(cfg) / 989e12)
    vanilla = dict(cfg, encoder="freq")
    run_r = dict(run, settings=vanilla)
    assert r["k2_roofline"](run_r) == pytest.approx(
        100 * arith.frame_flops(vanilla, 800, 800) / 989e12 / 0.2)
    assert r["mfu.render"](run_r) == pytest.approx(
        100 * arith.frame_flops(vanilla, 800, 800) / 989e12)
    # a reader that finds nothing returns nothing, never 0
    empty = dict(run, counts={"world": 1})
    assert r["mfu.train"](empty) is None and r["k2_roofline"](empty) is None
    # the reader a four-card cell will list (ROADMAP P10's dp4 cell)
    dp = cells.load_reader(cells.PKG / "metrics" / "allreduce_ms.dp.py")
    assert dp(run) is None                                             # one rank
    assert dp(dict(run, counts={"steps": 16, "world": 4})) == pytest.approx(1.0 / 16)
