"""The correctness check on the CPU at a small size (the configurations'
widths, few rays and samples, a 4-view 32x32 scene): the program run in
fp32 agrees with the reference, the control (float8 products) and the
faults a cell can have make ``correct`` false, and a sound run passes.

These drive the harness's run without its look for a card
(``harness.run_cell`` on ``cpu``), so the program's kernels take their plain
versions here; the card runs the same comparison at the cells' sizes."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

from port_bench import cells, check, harness, scene as scene_mod
from port_bench.tests.bench_copy import make_copy

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4321


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setattr(scene_mod, "CACHE", tmp_path / "cache")


def small_cell(tmp_path, kind="train", config="nerf-vanilla-blender", **flags):
    limits_of = {"nerf-vanilla-blender": "vanilla-train",
                 "ngp-hashgrid-blender": "hashgrid-train"}[config]
    if kind == "render":
        limits_of = "vanilla-render"
    root = make_copy(tmp_path, kind=kind, config=config, limits_of=limits_of, flags=flags)
    return cells.find_cell("small-cell", root=root)


def numbers_of(cell, side: dict, expect: dict) -> dict:
    """The train numbers of ``side`` (a :func:`harness.reference_steps`
    run, or the program's readings) against the reference ``expect``."""
    side = dict(side)
    side["own_losses"] = harness.losses_at(cell, SEED, CPU, side.pop("states"))
    return check.train_numbers(side, expect)


# Four position bands, as the repository's own step tests take: at ten, the
# top band (2^9) turns the ulp by which the program's sample template
# (jnp.linspace's rounding) differs from the reference's into gradient gaps
# of 1e-3.
@pytest.mark.parametrize("config", ["nerf-vanilla-blender", "ngp-hashgrid-blender"])
def test_program_in_fp32_agrees_with_the_reference(tmp_path, config):
    """The program with fp32 products reads an order of magnitude inside
    every limit."""
    cell = small_cell(tmp_path, config=config, compute_dtype="float32", pos_num_freqs=4)
    line = harness.run_cell(cell, SEED, 0.5, False, CPU)
    for name, c in line["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert line["correct"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


def test_render_in_fp32_agrees_with_the_reference(tmp_path):
    cell = small_cell(tmp_path, kind="render", compute_dtype="float32", pos_num_freqs=4)
    line = harness.run_cell(cell, SEED, 0.5, False, CPU)
    assert line["checks"]["frame_gap"]["value"] < 0.05, line["checks"]
    assert line["correct"]
    assert set(line["metrics"]) == {"render_frame_s", "setup_s"}


@pytest.mark.parametrize("config", ["nerf-vanilla-blender", "ngp-hashgrid-blender"])
def test_control_fails_the_limits(tmp_path, config):
    """The reference with float8 products, in the program's place, fails
    at least one of the cell's numbers; the reference against itself reads
    zero."""
    cell = small_cell(tmp_path, config=config)
    expect = harness.reference_steps(cell, SEED, CPU, k=2)
    same = numbers_of(cell, harness.reference_steps(cell, SEED, CPU, k=2), expect)
    assert max(same.values()) < 1e-6
    control = numbers_of(cell, harness.reference_steps(cell, SEED, CPU, mode="fp8", k=2),
                         expect)
    ok, checks = check.verdict(control, cell["limits"])
    assert not ok, checks


def test_render_control_fails_the_limit(tmp_path):
    cell = small_cell(tmp_path, kind="render")
    sp = harness.scene_params(cell)
    poses = harness.path_poses(3, sp["radius"])
    f = scene_mod.focal(sp)
    K = torch.tensor([[f, 0, 16], [0, f, 16], [0, 0, 1]], dtype=torch.float32).numpy()
    frames = [(i, torch.randint(0, 32 * 32, (256,)).numpy(), None) for i in range(3)]
    expect = harness.reference_frames(cell, SEED, frames, poses, K, CPU)
    own = harness.reference_frames(cell, SEED, frames, poses, K, CPU, mode="bf16")
    control = harness.reference_frames(cell, SEED, frames, poses, K, CPU, mode="fp8")
    gap = harness.worst_frame_gap(cell, [{k: c[k] for k in ("rgb", "acc", "depth")}
                                         for c in control], expect, own)
    assert gap > cell["limits"]["frame_gap"]
    assert harness.worst_frame_gap(cell, own, expect, own) == pytest.approx(1.0)


# ---- faults planted in the program make correct false

def test_fault_state_unchanged(tmp_path, monkeypatch):
    from nerf_sandbox_tpu_torch.train import step as prog_step
    real = prog_step.Optimizer.update

    def frozen(self, grads, state, params, grad_sq=None):
        updates, new = real(self, grads, state, params, grad_sq)
        return {k: torch.zeros_like(u) for k, u in updates.items()}, new
    monkeypatch.setattr(prog_step.Optimizer, "update", frozen)
    line = harness.run_cell(small_cell(tmp_path), SEED, 0.5, False, CPU)
    assert not line["correct"]
    assert line["checks"]["move_gap"]["value"] == pytest.approx(1.0)


def test_fault_half_batch(tmp_path, monkeypatch):
    from nerf_sandbox_tpu_torch.train import step as prog_step
    real = prog_step._mse

    def half(comp, batch):
        n = comp.shape[0] // 2
        return real(comp[:n], {"rgb": batch["rgb"][:n]})
    monkeypatch.setattr(prog_step, "_mse", half)
    line = harness.run_cell(small_cell(tmp_path), SEED, 0.5, False, CPU)
    assert not line["correct"], line["checks"]


def test_fault_stale_frame(tmp_path, monkeypatch):
    """Each frame answered with the image of the pose after it on the path,
    so that every frame of the window is wrong however few it completes."""
    from nerf_sandbox_tpu_torch.render import renderer
    cell = small_cell(tmp_path, kind="render")
    poses = harness.path_poses(int(cell["traffic"]["path_frames"]),
                               harness.scene_params(cell)["radius"])
    real = renderer.render_pose

    def stale(*args, **kw):
        i = next(j for j, p in enumerate(poses) if np.allclose(p, args[3]))
        return real(*args[:3], poses[(i + 1) % len(poses)], *args[4:], **kw)
    monkeypatch.setattr(renderer, "render_pose", stale)
    line = harness.run_cell(cell, SEED, 0.5, False, CPU)
    assert not line["correct"], line["checks"]


# ---- several ranks (gloo processes on the CPU)

def _rank_without_exchange(cell, *args, device=None):
    """A rank whose step leaves out the sum over the ranks."""
    from nerf_sandbox_tpu_torch.train import step as prog_step
    prog_step.all_reduce_sum = lambda plan, t: t
    return harness.train_rank(cell, *args, device=device)


def dp_cell(tmp_path):
    bench = cells.load_benchmark()
    limits_of = ("vanilla-train-dp4" if any(w["name"] == "vanilla-train-dp4"
                                            for w in bench["workloads"]) else "vanilla-train")
    root = make_copy(tmp_path, limits_of=limits_of,
                     flags={"mesh_devices": 2, "rays_per_batch": 64,
                            "compute_dtype": "float32", "pos_num_freqs": 4})
    return cells.find_cell("small-cell", root=root)


def test_ranks_sound_and_without_their_exchange(tmp_path):
    """Two ranks (fp32 products, as the one-process agreement test) run the
    cell as one process does, every rank's parameters against the
    reference, and with the sum over the ranks left out the check fails."""
    cell = dp_cell(tmp_path)
    line = harness.run_cell(cell, SEED, 0.5, False, CPU)
    assert line["correct"], line["checks"]
    paths = harness.cell_paths(cell)
    ranks = harness.on_ranks(cell, _rank_without_exchange,
                             (SEED, 0.5, False, 0.0, paths), CPU)
    expect = harness.reference_steps(cell, SEED, CPU)
    numbers = numbers_of(cell, ranks[0]["readings"], expect)
    ok, checks = check.verdict(numbers, cell["limits"])
    assert not ok, checks
    assert numbers["loss_gap"] > 0.4


def _rank_loading_jax(cell, *args, device=None):
    """A rank that has a module named ``jax`` loaded (a stub) when its
    window closes, on rank 1 alone."""
    from nerf_sandbox_tpu_torch.parallel import dist
    if dist.rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return harness.train_rank(cell, *args, device=device)


def test_a_rank_that_loads_jax_refuses_the_run(tmp_path, monkeypatch):
    """The run's look for JAX covers the spawned ranks, not only the
    process that prints the result: a rank that loaded ``jax`` makes the
    run raise, naming it, and print no line."""
    cell = dp_cell(tmp_path)
    real = harness.on_ranks
    monkeypatch.setattr(harness, "on_ranks",
                        lambda cell, fn, args, dev: real(cell, _rank_loading_jax, args, dev))
    assert "jax" not in sys.modules
    with pytest.raises(harness.ForbiddenModules, match="jax") as err:
        harness.run_cell(cell, SEED, 0.5, False, CPU)
    assert err.value.names == ["jax"]
