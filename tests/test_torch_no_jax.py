"""The port stands alone: no module of ``nerf_sandbox_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on CUDA unless the caller asks for the CPU — with no CUDA device they raise.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nerf_sandbox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "nerf_sandbox_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(f.relative_to(ROOT).as_posix(), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_points_raise_without_cuda(monkeypatch):
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops.fused_mlp import fused_nerf_apply
    from nerf_sandbox_tpu_torch.ops.fused_raymarch import fused_raymarch
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanes, KPlanesConfig
    from nerf_sandbox_tpu_torch.ops.kplanes_encode import (
        fused_kplanes_encode, pack_kplanes)
    from nerf_sandbox_tpu_torch.ops.precision_probe import precision_dot
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose, render_rays_chunked)

    cfg = NeRFConfig(63, 27, n_layers=3, hidden_dim=128, skip_pos=1)
    pos_b, dir_b = vanilla_encoders()
    kcfg = KPlanesConfig(plane_res=(4,), plane_features=8, line_res=4,
                         line_features=8, aabb_scale=2.0, hybrid_freqs=1)
    kp_cfg = NeRFConfig(kcfg.out_dim, 27, n_layers=3, hidden_dim=128, skip_pos=1)
    kp_model = NeRFMLP(kp_cfg, grid_cfg=kcfg, device="cpu")
    kp_hyper = EvalHyper(model=kp_cfg, nc_eval=4, nf_eval=4, pos_encoder="kplanes",
                         enc_cfg=kcfg, scene_contraction=True, lindisp=True,
                         use_kernel=True)
    kp_tile = make_tile_renderer(kp_hyper, None, dir_b, device="cpu")
    packed_kp = pack_kplanes(kp_model.pos_grid, kcfg)
    model = NeRFMLP(cfg, device="cpu")
    tile = make_tile_renderer(EvalHyper(model=cfg, nc_eval=4, nf_eval=4),
                              pos_b, dir_b, device="cpu")
    ipe_tile = make_tile_renderer(EvalHyper(model=cfg, nc_eval=4, nf_eval=4,
                                            ipe=True, use_kernel=True),
                                  pos_b, dir_b, device="cpu")
    ro = torch.zeros(2, 3)
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    z = torch.linspace(2, 6, 4).expand(2, 4)
    K = np.array([[2.0, 0, 1], [0, 2.0, 1], [0, 0, 1]], np.float32)
    calls = {
        "NeRFMLP": lambda: NeRFMLP(cfg),
        "make_tile_renderer": lambda: make_tile_renderer(
            EvalHyper(model=cfg), pos_b, dir_b),
        "render_pose": lambda: render_pose(tile, model, model, np.eye(4), 2, 2, K),
        "render_rays_chunked": lambda: render_rays_chunked(
            tile, model, model, ro, rd, torch.ones(2, 1), rd),
        "nerf_forward_pass": lambda: nerf_forward_pass(
            model, ro, rd, z, pos_bands=pos_b, dir_bands=dir_b, white_bkgd=True),
        "fused_raymarch": lambda: fused_raymarch(
            model, ro, rd, z, torch.ones(2), torch.zeros(2, 27), pos_b),
        "fused_nerf_apply": lambda: fused_nerf_apply(
            model, torch.zeros(2, 63), torch.zeros(2, 27)),
        "KPlanes": lambda: KPlanes(kcfg),
        "NeRFMLP(grid_cfg)": lambda: NeRFMLP(kp_cfg, grid_cfg=kcfg),
        "fused_kplanes_encode": lambda: fused_kplanes_encode(
            packed_kp, torch.zeros(2, 3), 64),
        "make_tile_renderer(kplanes)": lambda: make_tile_renderer(
            kp_hyper, None, dir_b),
        "render_pose(kplanes)": lambda: render_pose(
            kp_tile, kp_model, kp_model, np.eye(4), 2, 2, K),
        "fused_raymarch(ipe)": lambda: fused_raymarch(
            model, ro, rd, z, torch.ones(2), torch.zeros(2, 27), pos_b,
            ipe_radii=torch.ones(2)),
        "render_pose(ipe)": lambda: render_pose(ipe_tile, model, model,
                                                np.eye(4), 2, 2, K),
        "precision_dot": lambda: precision_dot(torch.zeros(2, 3),
                                               torch.zeros(3, 2), "fp32"),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the same calls run on the CPU when asked to
    out = render_pose(tile, model, model, np.eye(4), 2, 2, K, device="cpu")
    assert out["rgb"].shape == (2, 2, 3)
    out = render_pose(kp_tile, kp_model, kp_model, np.eye(4), 2, 2, K,
                      device="cpu")
    assert np.isfinite(out["rgb"]).all()
    out = render_pose(ipe_tile, model, model, np.eye(4), 2, 2, K, device="cpu")
    assert np.isfinite(out["rgb"]).all()


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """The scene, the sampler and the train step run on CUDA unless asked
    for the CPU, and raise without a CUDA device; asked for the CPU they take
    a step there."""
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.data.sampler import (
        RayBatchSpec, SceneArrays, sample_ray_batch)
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.train.step import (
        TrainHyper, build_train_step, init_train_state, make_optimizer)

    K = np.array([[4.0, 0, 2], [0, 4.0, 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    scene = Scene([Frame(image=np.full((4, 4, 4), 200, np.uint8), K=K, c2w=c2w)])
    spec = RayBatchSpec(8, 4, 4)
    hyper = TrainHyper(model=NeRFConfig(63, 27, n_layers=3, hidden_dim=32, skip_pos=1),
                       nc=4, nf=4, compute_dtype="float32")
    tx = make_optimizer(5e-4, "none")
    pos_b, dir_b = vanilla_encoders()
    cpu_scene = SceneArrays.from_scene(scene, device="cpu")
    cpu_state = init_train_state(hyper, tx, near=2.0, far=6.0, device="cpu")
    calls = {
        "SceneArrays.from_scene": lambda: SceneArrays.from_scene(scene),
        "sample_ray_batch": lambda: sample_ray_batch(
            1, cpu_scene, spec, generator=torch.Generator()),
        "init_train_state": lambda: init_train_state(hyper, tx, near=2.0, far=6.0),
        "build_train_step": lambda: build_train_step(hyper, spec, tx, pos_b, dir_b),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    step = build_train_step(hyper, spec, tx, pos_b, dir_b, device="cpu")
    state, metrics = step(cpu_state, cpu_scene)
    assert int(state.step) == 1 and bool(metrics["finite"])
    assert all(t.device.type == "cpu" for t in state.opt_state["mu"].values())


def test_chip_smoke_refuses_without_cuda():
    """``chip_smoke.py`` has no CPU path: without a card it prints nothing on
    stdout and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
