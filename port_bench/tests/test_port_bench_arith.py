"""The yardstick's counts against figures worked out by hand."""

from __future__ import annotations

import json

import pytest

from port_bench import arith, cells
from port_bench.tests.bench_copy import REPO


def config(name):
    bench = cells.load_benchmark()
    path = REPO / [c["file"] for c in bench["configs"] if c["name"] == name][0]
    return cells.flags_of(json.loads(path.read_text()))


def test_vanilla_sample_macs():
    # trunk 63x256 + 3 x 256^2 + (256+63)x256 + 3 x 256^2, feature 256^2,
    # sigma 256, colour (256+27)x128 + 128x3
    assert arith.mlp_macs_per_sample(config("nerf-vanilla-blender")) == 593_408


def test_hashgrid_sample_macs():
    # the trunk's first and skip layers take the 32 hash features
    assert arith.mlp_macs_per_sample(config("ngp-hashgrid-blender")) == (
        32 * 256 + 3 * 65536 + (256 + 32) * 256 + 3 * 65536 + 65536 + 256
        + (256 + 27) * 128 + 128 * 3)


def test_train_step_flops():
    cfg = config("nerf-vanilla-blender")
    assert arith.train_samples_per_step(cfg) == 1024 * 256 == 2 ** 18
    assert arith.train_flops_per_step(cfg) == pytest.approx(0.9333e12, rel=1e-3)


def test_frame_bound():
    cfg = config("nerf-vanilla-blender")
    seconds = arith.frame_flops(cfg, 800, 800) / arith.PEAK_BF16_FLOPS
    assert seconds == pytest.approx(0.197, abs=5e-4)
    # K2's launches: 40 tiles of 16384 rays, 1.258 ms coarse + 3.775 ms fine each
    assert arith.k2_launch_flops(cfg, 16384, 64) / arith.PEAK_BF16_FLOPS == pytest.approx(
        1.258e-3, rel=1e-3)
    assert arith.k2_launch_flops(cfg, 16384, 192) / arith.PEAK_BF16_FLOPS == pytest.approx(
        3.775e-3, rel=1e-3)


def test_hash_scatter_bytes():
    # the fine pass: 1024 rays x 192 points x 16 levels x 8 corners = 25.2 M
    # pairs, each a 4-byte key and 2 fp32 features, onto 16 x 2^19 rows of 2
    cfg = config("ngp-hashgrid-blender")
    coarse, fine = arith.hash_scatters_per_step(cfg)
    assert fine == (25_165_824, 2, 16 * 2 ** 19)
    assert arith.hash_scatter_bytes(*fine) == pytest.approx(369e6, rel=2e-3)
    assert coarse[0] == 8_388_608
    assert arith.hash_scatter_bytes_per_step(cfg) / arith.PEAK_HBM_BYTES == pytest.approx(
        0.1602e-3, rel=1e-3)
