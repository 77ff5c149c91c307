"""The CUDA kernels K1 (fused MLP) and K2 (fused ray-march) against their
plain PyTorch versions, on the card. Every test here carries the ``cuda``
marker and skips without a CUDA device (the ``cuda`` fixture decides at run
time). This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 0.05 (the JAX fused-MLP test's bf16 bound); K2 comp, weights
and acc 2e-2, depth 0.1 (``tests/test_fused_raymarch.py``) on rays off the
infinite last bin's step (``chip_smoke.last_bin_kink``), and weights before
the last sample on every ray; ERT against none 1e-3; padding 1e-5.
"""

import numpy as np
import pytest
import torch

from nerf_sandbox_tpu_torch.core.encoding import positional_encoding, vanilla_encoders
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
from nerf_sandbox_tpu_torch.render.renderer import (
    EvalHyper, make_tile_renderer, render_pose)
from nerf_sandbox_tpu_torch.render.validation import compute_psnr

pytestmark = pytest.mark.cuda

VANILLA = NeRFConfig(63, 27, n_layers=8, hidden_dim=256, skip_pos=4)
SMALL = NeRFConfig(63, 27, n_layers=3, hidden_dim=128, skip_pos=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(cfg, seed, dev, sigma_shift=0.0):
    m = NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    with torch.no_grad():
        m.sigma_out.bias += sigma_shift
    return m


def _enc(q, seed, dev):
    rng = np.random.RandomState(seed)
    ep = torch.from_numpy((rng.normal(size=(q, 63)) * 0.5).astype(np.float32))
    ed = torch.from_numpy((rng.normal(size=(q, 27)) * 0.5).astype(np.float32))
    return ep.to(dev), ed.to(dev)


def _rays(b, n, seed, dev):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nr = rng.uniform(0.8, 1.3, (b,)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (b, n)), axis=-1).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (o, d, nr, z)]


@pytest.mark.parametrize("cfg", [VANILLA, SMALL], ids=["8x256", "3x128"])
@pytest.mark.parametrize("q", [1, 63, 65, 1000, 70000])
def test_k1_matches_plain(cuda, cfg, q):
    m = _model(cfg, 0, cuda)
    ep, ed = _enc(q, q, cuda)
    before = fm.fused_nerf_apply.launches
    got = fm.fused_nerf_apply(m, ep, ed)
    torch.cuda.synchronize()
    assert fm.fused_nerf_apply.launches == before + 1
    want = fm.fused_nerf_apply_plain(fm.pack_nerf_params(m), ep, ed)
    assert got.shape == (q, 4) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 0.05


def test_k1_rows_are_independent(cuda):
    m = _model(VANILLA, 1, cuda)
    ep, ed = _enc(2049, 7, cuda)
    full = fm.fused_nerf_apply(m, ep, ed)
    head = fm.fused_nerf_apply(m, ep[:100], ed[:100])
    assert float((full[:100] - head).abs().max()) <= 1e-5


def test_k1_rejects_bad_inputs(cuda):
    m = _model(VANILLA, 0, cuda)
    ep, ed = _enc(8, 0, cuda)
    with pytest.raises(ValueError):
        fm.fused_nerf_apply(m, ep[:, :60], ed)
    with pytest.raises(ValueError, match="model is on"):
        fm.fused_nerf_apply(_model(VANILLA, 0, "cpu"), ep, ed)


def _k2_pair(m, rays, dev, **kw):
    o, d, nr, z = rays
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    got = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, **kw)
    packed = fm.pack_nerf_params(m)
    dt = fr._deltas(z, nr, kw.get("infinite_last_bin", True))
    plain_kw = {k: v for k, v in kw.items()
                if k in ("sigma_activation", "white_bkgd")}
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed, o, d, z, dt, nr, ed, pos_b, **plain_kw))
    # rays whose last sigma logit sits at the infinite last bin's step
    pts = o + d * (z[:, -1:] * nr[:, None])
    enc = positional_encoding(pts, pos_b)
    k_logit = fm.fused_nerf_apply(packed, enc, ed)[:, 3]
    p_logit = fm.fused_nerf_apply_plain(packed, enc, ed)[:, 3]
    band = 2.0 * float((k_logit - p_logit).abs().max())
    off = p_logit.abs() >= band
    if not kw.get("infinite_last_bin", True):
        off = torch.ones_like(off)
    return got, want, off


@pytest.mark.parametrize("kw", [{}, {"white_bkgd": False},
                                {"sigma_activation": "softplus"},
                                {"infinite_last_bin": False}],
                         ids=["vanilla", "black_bkgd", "softplus", "finite_last_bin"])
@pytest.mark.parametrize("shape", [(37, 21), (300, 64), (4096, 192)])
def test_k2_matches_plain(cuda, kw, shape):
    m = _model(VANILLA, 2, cuda)
    before = fr.fused_raymarch.launches
    got, want, off = _k2_pair(m, _rays(*shape, 3, cuda), cuda, **kw)
    torch.cuda.synchronize()
    assert fr.fused_raymarch.launches == before + 1
    assert int(off.sum()) >= 0.95 * shape[0]
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def test_k2_rays_are_independent(cuda):
    m = _model(VANILLA, 4, cuda)
    o, d, nr, z = _rays(40, 19, 5, cuda)
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    full = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b)
    part = fr.fused_raymarch(m, o[:7], d[:7], z[:7], nr[:7], ed[:7], pos_b)
    for f, p in zip(full, part):
        assert float((f[:7] - p).abs().max()) <= 1e-5


def test_k2_early_termination(cuda):
    """On a dense field every ray saturates: ERT skips whole blocks, writes
    zero weights there, and moves each output by less than 1e-3."""
    m = _model(VANILLA, 6, cuda, sigma_shift=10.0)
    o, d, nr, z = _rays(2048, 192, 7, cuda)
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    full = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b)
    ert = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, ert_eps=1e-4)
    for f, e in zip(full, ert):
        assert float((f - e).abs().max()) <= 1e-3
    assert float((ert[1] == 0).float().mean()) > 0.5


def test_render_pose_on_the_card(cuda):
    cfg = VANILLA
    mc, mf = _model(cfg, 8, cuda), _model(cfg, 9, cuda)
    pos_b, dir_b = vanilla_encoders()
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    frames = {}
    for key, kw in (("kernel", dict(use_kernel=True)),
                    ("kernel_ert", dict(use_kernel=True, eval_ert_eps=1e-4)),
                    ("plain", dict(use_kernel=False))):
        tile = make_tile_renderer(EvalHyper(model=cfg, **kw), pos_b, dir_b,
                                  device=cuda)
        frames[key] = render_pose(tile, mc, mf, c2w, 32, 32, K, eval_chunk=300,
                                  device=cuda)
    for f in frames.values():
        assert np.isfinite(f["rgb"]).all()
        assert f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0
    # whole-frame agreement of the kernel path and the plain path
    assert compute_psnr(frames["kernel"]["rgb"], frames["plain"]["rgb"]) >= 30.0
    # early ray termination through the renderer: its coarse weights steer
    # the fine samples, so the frame is held by PSNR, not per pixel
    assert compute_psnr(frames["kernel_ert"]["rgb"], frames["kernel"]["rgb"]) >= 40.0
