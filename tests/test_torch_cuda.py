"""The CUDA kernels K1 (fused MLP), K2 (fused ray-march, with its K2c
contraction, K3 k-planes and K4 IPE branches), K3's encode-only entry, K5
(the precision probe) and the hash tables' gradient scatter against their
plain PyTorch versions (K2 also at the occupancy / proposal tile shape, one
pass of 128 samples on a culled batch), and the train step
(``train/step.py``) against the same step on the CPU, on the card, its
captured chunks (frequency and hash grid) against eager steps. Every test here carries the ``cuda``
marker and skips without a CUDA device (the ``cuda`` fixture decides at run
time). This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: K1 0.05 (the JAX fused-MLP test's bf16 bound); K2 comp, weights
and acc 2e-2, depth 0.1 (``tests/test_fused_raymarch.py``) on rays off the
infinite last bin's step (``chip_smoke.last_bin_kink``), and weights before
the last sample on every ray; ERT against none 1e-3; padding 1e-5; K3
encode-only within one bf16 ulp of its plain version, |Δ| <= 2^-7·max(1, |v|);
K5 within K·2^-23·Σ|a||b| of its plain version (fp32 accumulation of K
products).
"""

import numpy as np
import pytest
import torch

from nerf_sandbox_tpu_torch.core.encoding import (
    integrated_positional_encoding, positional_encoding, scene_contract,
    vanilla_encoders)
from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
from nerf_sandbox_tpu_torch.ops import precision_probe as pp
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
@pytest.mark.parametrize("q", [1, 63, 65, 127, 129, 255, 257, 1000, 70000])
def test_k1_matches_plain(cuda, cfg, q):
    """q on both sides of the 128-row tile (two warpgroups of 64 rows)."""
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


WIDE = {"8x384": NeRFConfig(63, 27, n_layers=8, hidden_dim=384, skip_pos=4),
        "8x512": NeRFConfig(63, 27, n_layers=8, hidden_dim=512, skip_pos=4),
        "8x640": NeRFConfig(63, 27, n_layers=8, hidden_dim=640, skip_pos=4),
        "8x1024": NeRFConfig(63, 27, n_layers=8, hidden_dim=1024, skip_pos=4),
        "3x1152": NeRFConfig(63, 27, n_layers=3, hidden_dim=1152, skip_pos=1)}


@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("q", [1, 127, 129, 70000])
def test_k1_wide_matches_plain(cuda, wname, q):
    """Hidden widths 384 and 512: the wide path (activations in shared
    memory, output chunks of 256 columns; 384's trunk ends on a 128-column
    chunk, its colour head on a 64-column one); 640, 1024 and 1152: the
    large route (activations in global scratch, output chunks of 256
    columns; 640's trunk and 1152's end on a 128-column chunk, their colour
    heads on a 64-column one)."""
    m = _model(WIDE[wname], 20, cuda)
    ep, ed = _enc(q, q + 1, cuda)
    before = fm.fused_nerf_apply.launches
    large = fm.fused_nerf_apply.large_launches
    got = fm.fused_nerf_apply(m, ep, ed)
    torch.cuda.synchronize()
    assert fm.fused_nerf_apply.launches == before + 1
    assert fm.fused_nerf_apply.large_launches == large + int(fm.is_large(m.cfg))
    want = fm.fused_nerf_apply_plain(fm.pack_nerf_params(m), ep, ed)
    assert got.shape == (q, 4) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 0.05


K2_ROUTES = ("freq", "freq_contract", "ipe", "ipe_contract", "kplanes",
             "kplanes_contract")


@pytest.mark.parametrize("route", K2_ROUTES)
@pytest.mark.parametrize("wname", WIDE)
@pytest.mark.parametrize("b", [1, 33, 16385])
def test_k2_wide_routes_match_plain(cuda, route, wname, b):
    """Every K2 route on the wide instantiations (384, 512) and on the large
    route (640, 1024, and 1152 for chunk tails), B off the ray groups, N = 63 off the passes; a finite
    last bin, so every ray is held: comp, w and acc at 2e-2, depth as
    sum(w z) at 2e-2 x z_far. The k-planes routes run the full-width grid
    (71 columns padded to 128, the tightest shared-memory budget)."""
    cfg = WIDE[wname]
    contract = route.endswith("contract")
    rays = _rays(b, 63, 21, cuda)
    fr.reset_launches()
    if route.startswith("kplanes"):
        m = _kp_model(KP_FULL, 22, cuda, hidden=cfg.hidden_dim)
        kp = ke.pack_kplanes(m.pos_grid, KP_FULL)
        got, want, _ = _k2_kp_pair(m, kp, rays, contract, infinite_last_bin=False)
    elif route.startswith("ipe"):
        m = _model(cfg, 23, cuda)
        got, want, _ = _k4_pair(m, rays, _radii(b, 24, cuda), contract,
                                infinite_last_bin=False)
    else:
        m = _model(cfg, 25, cuda)
        got, want, _ = _k2_pair(m, rays, cuda, infinite_last_bin=False,
                                scene_contraction=contract)
    torch.cuda.synchronize()
    routes = fr.fused_raymarch.route_launches
    assert fr.fused_raymarch.launches == 1
    assert routes[route.split("_")[0]] == 1 and routes["contract"] == int(contract)
    assert routes["large"] == int(cfg.hidden_dim > 512)
    assert fr.fused_raymarch.tile_launches == {(route.split("_")[0], 63): 1}
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == b
        assert torch.isfinite(g).all()
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 2e-2
    assert float((got[3] * got[2] - want[3] * want[2]).abs().max()) <= 2e-2 * 6.0


@pytest.mark.parametrize("shape", [(8, 192, 4), (8, 256, 0), (2, 256, 1),
                                   (3, 640, 1), (3, 1024, 1)])
def test_hidden_width_the_kernels_do_not_take_raises(cuda, shape):
    """Only an MLP that JAX's fusable refuses (hidden width off a multiple of
    128, skip layer outside the trunk, fewer than three layers) raises on
    CUDA, before any launch (it never falls back to the plain version);
    hidden widths 640 and 1024 launch K1 and K2 on the large route."""
    n_layers, hidden, skip = shape
    cfg = NeRFConfig(63, 27, n_layers=n_layers, hidden_dim=hidden, skip_pos=skip)
    m = _model(cfg, 0, cuda)
    ep, ed = _enc(8, 0, cuda)
    o, d, nr, z = _rays(8, 16, 0, cuda)
    pos_b, dir_b = vanilla_encoders()
    k1, k2 = fm.fused_nerf_apply.launches, fr.fused_raymarch.launches
    if not fm.fusable(cfg):
        with pytest.raises(ValueError, match="fused kernels do not cover"):
            fm.fused_nerf_apply(m, ep, ed)
        with pytest.raises(ValueError, match="fused kernels do not cover"):
            fr.fused_raymarch(m, o, d, z, nr, positional_encoding(d, dir_b), pos_b)
        assert fm.fused_nerf_apply.launches == k1 and fr.fused_raymarch.launches == k2
        return
    fm.check_kernel_shape(cfg)
    fm.fused_nerf_apply(m, ep, ed)
    fr.fused_raymarch(m, o, d, z, nr, positional_encoding(d, dir_b), pos_b)
    torch.cuda.synchronize()
    assert fm.fused_nerf_apply.launches == k1 + 1
    assert fr.fused_raymarch.launches == k2 + 1


def _k2_pair(m, rays, dev, **kw):
    o, d, nr, z = rays
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    got = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, **kw)
    packed = fm.pack_nerf_params(m)
    dt = fr._deltas(z, nr, kw.get("infinite_last_bin", True))
    plain_kw = {k: v for k, v in kw.items()
                if k in ("sigma_activation", "white_bkgd")}
    contract = kw.get("scene_contraction", False)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed, o, d, z, dt, nr, ed, pos_b, contract=contract, **plain_kw))
    # rays whose last sigma logit sits at the infinite last bin's step
    pts = o + d * (z[:, -1:] * nr[:, None])
    if contract:
        pts = scene_contract(pts)
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


@pytest.mark.parametrize("encoder", ["freq", "ipe"])
@pytest.mark.parametrize("b", [1, 33, 16385])
def test_k2_ragged_ray_groups(cuda, encoder, b):
    """B not a multiple of the 32-ray group nor of the 16 rays of a
    warpgroup, N not a multiple of the 4 samples of a pass, on the frequency
    encoder (K2) and the IPE one (K4). A finite last bin, so every ray is
    held (no last-bin kink): comp, w and acc at 2e-2, depth as sum(w z) at
    2e-2 x z_far (a ray with little weight has an ill-conditioned depth)."""
    m = _model(VANILLA, 12, cuda)
    rays = _rays(b, 63, 13, cuda)
    if encoder == "ipe":
        got, want, _ = _k4_pair(m, rays, _radii(b, 14, cuda), False,
                                infinite_last_bin=False)
    else:
        got, want, _ = _k2_pair(m, rays, cuda, infinite_last_bin=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[0] == b
        assert torch.isfinite(g).all()
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= 2e-2
    assert float((got[3] * got[2] - want[3] * want[2]).abs().max()) <= 2e-2 * 6.0


@pytest.mark.parametrize("kw", [{}, {"ipe": True}], ids=["freq", "ipe"])
def test_k2_small_model_matches_plain(cuda, kw):
    """The 3x128 MLP (the kernels' H = 128 instantiations, skip at 2)."""
    m = _model(SMALL, 15, cuda)
    rays = _rays(300, 64, 16, cuda)
    fr.reset_launches()
    if kw:
        got, want, off = _k4_pair(m, rays, _radii(300, 17, cuda), False)
    else:
        got, want, off = _k2_pair(m, rays, cuda)
    torch.cuda.synchronize()
    assert fr.fused_raymarch.launches == 1
    assert int(off.sum()) >= 0.95 * 300
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def test_k2_early_termination_ragged(cuda):
    """ERT on the dense model with B and N off the kernel's geometry: a group
    that stops writes zero weights and the others go on."""
    m = _model(VANILLA, 18, cuda, sigma_shift=10.0)
    o, d, nr, z = _rays(1000, 190, 19, cuda)
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    full = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b)
    ert = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, ert_eps=1e-4)
    for f, e in zip(full, ert):
        assert float((f - e).abs().max()) <= 1e-3
    assert float((ert[1] == 0).float().mean()) > 0.5


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


KP_FULL = KPlanesConfig((64, 128), 8, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
KP_CFGS = {"full_hybrid6": KP_FULL,
           "full_4d": KP_FULL._replace(hybrid_freqs=0, time_res=8),
           "small_hybrid3": KPlanesConfig((8, 16), 8, 32, 16, aabb_scale=2.0,
                                          hybrid_freqs=3)}


def _kp_model(kcfg, seed, dev, n_layers=8, hidden=256, skip=4):
    cfg = NeRFConfig(kcfg.out_dim, 27, n_layers=n_layers, hidden_dim=hidden,
                     skip_pos=skip)
    m = NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed),
                grid_cfg=kcfg, device=dev)
    if kcfg.time_res:   # time planes off their neutral 1.0
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            for name, t in m.pos_grid.named_parameters():
                if name == "line_t" or name.split("_")[-1] in ("xt", "yt", "zt"):
                    t += 0.3 * torch.randn(t.shape, generator=g).to(dev)
    return m


def _ulp_ok(got, want):
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("kname", KP_CFGS)
@pytest.mark.parametrize("q", [1, 63, 65, 5000])
def test_k3_encode_matches_plain(cuda, kname, q):
    kcfg = KP_CFGS[kname]
    m = _kp_model(kcfg, 1, cuda, n_layers=3, hidden=128, skip=1)
    kp = ke.pack_kplanes(m.pos_grid, kcfg, t=0.61 if kcfg.time_res else None)
    rng = np.random.RandomState(q)
    pts = torch.from_numpy(rng.uniform(-2.3, 2.3, (q, 3)).astype(np.float32)).to(cuda)
    before = ke.fused_kplanes_encode.launches
    got = ke.fused_kplanes_encode(kp, pts, 128)
    torch.cuda.synchronize()
    assert ke.fused_kplanes_encode.launches == before + 1
    want = ke.kplanes_encode_plain(kp, pts, 128)
    assert got.shape == (q, 128) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all() and _ulp_ok(got, want)
    assert not got[:, kp.cfg.out_dim:].float().any()


NARROW_KP = {f"F{F}_Fl{Fl}": KPlanesConfig((16, 32), F, 64, Fl, aabb_scale=2.0,
                                            hybrid_freqs=3)
             for F in (4, 6) for Fl in (8, 12)}


@pytest.mark.parametrize("kname", NARROW_KP)
def test_k3_narrow_features_bit_identical(cuda, kname):
    """Feature widths that are not multiples of 8 (texel groups of 4 or 2,
    lines starting off a 16-byte boundary): the encode-only entry is bit for
    bit its plain version, static and 4-D folded."""
    for kcfg, t in ((NARROW_KP[kname], None),
                    (NARROW_KP[kname]._replace(hybrid_freqs=0, time_res=5), 0.61)):
        m = _kp_model(kcfg, 30, cuda, n_layers=3, hidden=128, skip=1)
        kp = ke.pack_kplanes(m.pos_grid, kcfg, t=t)
        rng = np.random.RandomState(31)
        pts = torch.from_numpy(rng.uniform(-2.3, 2.3, (4099, 3)).astype(np.float32)).to(cuda)
        before = ke.fused_kplanes_encode.launches
        got = ke.fused_kplanes_encode(kp, pts, 64)
        torch.cuda.synchronize()
        assert ke.fused_kplanes_encode.launches == before + 1
        want = ke.kplanes_encode_plain(kp, pts, 64)
        assert torch.equal(got, want)
        assert not got[:, kcfg.out_dim:].float().any()


# The edges of K3's work list (csrc/kplanes_encode.cuh): the 360 default of
# 6 bands, one and four scales, 4 plane features (the encode-only entry's
# own instantiation) and one beside 12 line features (the one that reads
# the group widths from its arguments), 4-D with hybrid bands, and
# KP_MAX_BANDS bands (on the card both sides take CUDA's sinf and cosf,
# whose arguments reach 2^31 there).
K3_EDGES = {"hybrid6": KPlanesConfig((16, 32), 8, 64, 16, aabb_scale=2.0, hybrid_freqs=6),
            "f4_hybrid6": KPlanesConfig((16, 32), 4, 64, 16, aabb_scale=2.0,
                                        hybrid_freqs=6),
            "one_scale": KPlanesConfig((16,), 8, 64, 16, aabb_scale=2.0, hybrid_freqs=2),
            "four_scales": KPlanesConfig((8, 16, 24, 32), 8, 64, 16, aabb_scale=2.0,
                                         hybrid_freqs=1),
            "f1_fl12": KPlanesConfig((16, 32), 1, 64, 12, aabb_scale=2.0,
                                     hybrid_freqs=3),
            "4d_hybrid6": KPlanesConfig((16, 32), 8, 64, 16, aabb_scale=2.0,
                                        hybrid_freqs=6, time_res=5),
            "bands32": KPlanesConfig((16, 32), 8, 64, 16, aabb_scale=2.0,
                                     hybrid_freqs=ke.MAX_BANDS)}


@pytest.mark.parametrize("kname", K3_EDGES)
@pytest.mark.parametrize("q", ["0", "1", "63", "65", "sweep+1"])
@pytest.mark.parametrize("pad", [0, 24])
def test_k3_work_list_edges_bit_identical(cuda, kname, q, pad):
    """K3 encode-only bit for bit its plain version: rows padded to the first
    multiple of 8 that fits (no 16-byte zero units) or 24 columns more, at 0,
    1, 63 and 65 rows and one row past any sweep of the persistent grid (64
    rows a block, at most 16 blocks of 128 threads an SM)."""
    kcfg = K3_EDGES[kname]
    ep = -(-kcfg.out_dim // 8) * 8 + pad
    m = _kp_model(kcfg, 40, cuda, n_layers=3, hidden=128, skip=1)
    kp = ke.pack_kplanes(m.pos_grid, kcfg, t=0.61 if kcfg.time_res else None)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = sms * 16 * 64 + 1 if q == "sweep+1" else int(q)
    rng = np.random.RandomState(41)
    pts = torch.from_numpy(rng.uniform(-2.3, 2.3, (n, 3)).astype(np.float32)).to(cuda)
    want = ke.kplanes_encode_plain(kp, pts, ep)
    before = ke.fused_kplanes_encode.launches
    got = ke.fused_kplanes_encode(kp, pts, ep)
    torch.cuda.synchronize()
    assert ke.fused_kplanes_encode.launches == before + 1
    assert got.shape == (n, ep) and torch.equal(got, want)


@pytest.mark.parametrize("kname", NARROW_KP)
def test_k2_kplanes_narrow_features_match_plain(cuda, kname):
    """K2's k-planes route with contraction at the narrow feature widths."""
    kcfg = NARROW_KP[kname]
    m = _kp_model(kcfg, 32, cuda)
    kp = ke.pack_kplanes(m.pos_grid, kcfg)
    fr.reset_launches()
    got, want, off = _k2_kp_pair(m, kp, _rays(700, 63, 33, cuda), True)
    torch.cuda.synchronize()
    assert fr.fused_raymarch.route_launches["kplanes"] == 1
    assert int(off.sum()) >= 0.95 * off.numel()
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def _k2_kp_pair(m, kp, rays, contract, infinite_last_bin=True):
    """K2 with the k-planes encode against its plain version, and the rays
    off the last-bin kink (its band measured with K3 + K1 on the card)."""
    o, d, nr, z = rays
    _, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    got = fr.fused_raymarch(m, o, d, z, nr, ed, None, kp_params=kp,
                            kp_cfg=kp.cfg, scene_contraction=contract,
                            infinite_last_bin=infinite_last_bin)
    packed = fm.pack_nerf_params(m)
    dt = fr._deltas(z, nr, infinite_last_bin)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed, o, d, z, dt, nr, ed, None, contract=contract, kp=kp))
    pts = o + d * (z[:, -1:] * nr[:, None])
    if contract:
        pts = scene_contract(pts)
    P, ep = m.cfg.enc_pos_dim, fm._enc_pads(m.cfg)[0]
    k_logit = fm.fused_nerf_apply(packed, ke.fused_kplanes_encode(kp, pts, ep)[:, :P], ed)[:, 3]
    p_logit = fm.fused_nerf_apply_plain(
        packed, ke.kplanes_encode_plain(kp, pts, ep)[:, :P], ed)[:, 3]
    band = 2.0 * float((k_logit - p_logit).abs().max())
    off = p_logit.abs() >= band if infinite_last_bin else torch.ones_like(p_logit, dtype=bool)
    return got, want, off


K2_KP_CASES = {"static": (KP_FULL._replace(hybrid_freqs=0), False),
               "hybrid_contracted": (KP_FULL, True),
               "4d_fold": (KP_CFGS["full_4d"], False)}


@pytest.mark.parametrize("case", K2_KP_CASES)
def test_k2_kplanes_matches_plain(cuda, case):
    kcfg, contract = K2_KP_CASES[case]
    m = _kp_model(kcfg, 3, cuda)
    kp = ke.pack_kplanes(m.pos_grid, kcfg, t=0.37 if kcfg.time_res else None)
    fr.reset_launches()
    got, want, off = _k2_kp_pair(m, kp, _rays(512, 64, 5, cuda), contract,
                                 infinite_last_bin=not kcfg.time_res)
    torch.cuda.synchronize()
    routes = fr.fused_raymarch.route_launches
    assert fr.fused_raymarch.launches == 1 and routes["kplanes"] == 1
    assert routes["freq"] == 0 and routes["contract"] == int(contract)
    assert routes["tfold"] == int(kcfg.time_res > 0)
    assert int(off.sum()) >= 0.95 * off.numel()
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def test_k2_freq_contraction_matches_plain(cuda):
    m = _model(VANILLA, 2, cuda)
    fr.reset_launches()
    got, want, off = _k2_pair(m, _rays(300, 64, 9, cuda), cuda,
                              scene_contraction=True, infinite_last_bin=False)
    routes = fr.fused_raymarch.route_launches
    assert routes["freq"] == 1 and routes["contract"] == 1
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert float((g - w).abs().max()) <= tol


def test_kplanes_on_cuda_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(fr, "fused_raymarch_plain", boom)
    monkeypatch.setattr(fr, "kplanes_encode_plain", boom)
    monkeypatch.setattr(ke, "kplanes_encode_plain", boom)
    m = _kp_model(KP_FULL, 4, cuda)
    o, d, nr, z = _rays(64, 32, 1, cuda)
    _, dir_b = vanilla_encoders()
    before = dict(fr.fused_raymarch.route_launches)
    out = fr.fused_raymarch(m, o, d, z, nr, positional_encoding(d, dir_b), None,
                            kp_params=m.pos_grid, kp_cfg=KP_FULL,
                            scene_contraction=True)
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in out)
    after = fr.fused_raymarch.route_launches
    assert after["kplanes"] == before["kplanes"] + 1
    assert after["contract"] == before["contract"] + 1
    kp = ke.pack_kplanes(m.pos_grid, KP_FULL)
    n = ke.fused_kplanes_encode.launches
    ke.fused_kplanes_encode(kp, o, 128)
    assert ke.fused_kplanes_encode.launches == n + 1


def test_contracted_kplanes_render_pose_on_the_card(cuda):
    mc, mf = _kp_model(KP_FULL, 8, cuda), _kp_model(KP_FULL, 9, cuda)
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.0
    frames = {}
    for key, kw in (("kernel", dict(use_kernel=True)),
                    ("plain", dict(use_kernel=False))):
        hyper = EvalHyper(model=mc.cfg, samp_near=0.125, samp_far=22.5,
                          lindisp=True, scene_contraction=True,
                          pos_encoder="kplanes", enc_cfg=KP_FULL, **kw)
        tile = make_tile_renderer(hyper, None, vanilla_encoders()[1], device=cuda)
        frames[key] = render_pose(tile, mc, mf, c2w, 32, 32, K, eval_chunk=300,
                                  device=cuda)
    for f in frames.values():
        assert np.isfinite(f["rgb"]).all()
        assert f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0
    assert compute_psnr(frames["kernel"]["rgb"], frames["plain"]["rgb"]) >= 30.0


@pytest.mark.parametrize("encoder", ["freq", "kplanes_contracted"])
def test_k2_one_pass_at_128_on_a_culled_batch(cuda, encoder):
    """The tile shape of occupancy and proposal sampling: one K2 pass of 128
    samples a ray, here on 1000 rays (a culled tile: a multiple of 8, not of
    64), against its plain version."""
    fr.reset_launches()
    rays = _rays(1000, 128, 11, cuda)
    if encoder == "freq":
        got, want, off = _k2_pair(_model(VANILLA, 2, cuda), rays, cuda)
        key = ("freq", 128)
    else:
        m = _kp_model(KP_FULL, 3, cuda)
        got, want, off = _k2_kp_pair(m, ke.pack_kplanes(m.pos_grid, KP_FULL), rays, True)
        key = ("kplanes", 128)
    torch.cuda.synchronize()
    assert fr.fused_raymarch.tile_launches == {key: 1}
    assert int(off.sum()) >= 0.95 * off.numel()
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def test_occupancy_render_pose_on_the_card(cuda):
    """An occupancy render with culling (``eval_fine_frac`` 0.5: 152 of each
    300-ray tile, K rounded to 8) through K2 at 128 samples against the
    plain path, on a grid with a dense core."""
    from nerf_sandbox_tpu_torch.models.occupancy import OccupancyConfig
    m = _model(VANILLA, 4, cuda, sigma_shift=1.0)
    ocfg = OccupancyConfig(resolution=16)
    R = ocfg.resolution
    ijk = torch.stack(torch.meshgrid(*[torch.arange(R)] * 3, indexing="ij"), -1)
    grid = ((ijk - (R - 1) / 2.0).norm(dim=-1) < R / 4).float().reshape(-1).to(cuda) * 50.0
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    frames = {}
    for key, kw in (("kernel", dict(use_kernel=True)), ("plain", dict(use_kernel=False))):
        hyper = EvalHyper(model=m.cfg, nf_eval=128, sampling_mode="occupancy",
                          occ_cfg=ocfg, eval_fine_frac=0.5, **kw)
        tile = make_tile_renderer(hyper, *vanilla_encoders(), device=cuda)
        fr.reset_launches()
        frames[key] = render_pose(tile, grid, m, c2w, 32, 32, K, eval_chunk=300,
                                  device=cuda)
        torch.cuda.synchronize()
        if key == "kernel":
            assert fr.fused_raymarch.tile_launches == {("freq", 128): 4}
    for f in frames.values():
        assert np.isfinite(f["rgb"]).all()
        assert f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0
    assert compute_psnr(frames["kernel"]["rgb"], frames["plain"]["rgb"]) >= 30.0


def _radii(b, seed, dev, hi=3e-2):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(5e-4, hi, (b,)).astype(np.float32)).to(dev)


def _k4_pair(m, rays, radii, contract, infinite_last_bin=True, **kw):
    """K2's IPE instantiation (K4) against its plain version, and the rays
    off the last-bin kink (its band measured on the last sample's IPE rows
    with K1 and its plain version; every ray with a finite last bin)."""
    o, d, nr, z = rays
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    got = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, ipe_radii=radii,
                            scene_contraction=contract,
                            infinite_last_bin=infinite_last_bin, **kw)
    packed = fm.pack_nerf_params(m)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed, o, d, z, fr._deltas(z, nr, infinite_last_bin), nr, ed, pos_b,
        contract=contract, radii=radii))
    if not infinite_last_bin:
        return got, want, torch.ones(z.shape[0], dtype=torch.bool, device=z.device)
    mean, var = fr.ipe_gaussians(o, d, z * nr[:, None], radii, contract)
    enc = integrated_positional_encoding(mean[:, -1], var[:, -1], pos_b)
    k_logit = fm.fused_nerf_apply(packed, enc, ed)[:, 3]
    p_logit = fm.fused_nerf_apply_plain(packed, enc, ed)[:, 3]
    band = 2.0 * float((k_logit - p_logit).abs().max())
    return got, want, p_logit.abs() >= band


@pytest.mark.parametrize("contract", [False, True], ids=["lift", "contracted"])
@pytest.mark.parametrize("shape", [(37, 21), (301, 63), (4095, 192)])
def test_k4_matches_plain(cuda, contract, shape):
    """B not a multiple of the 16-ray block, N not a multiple of the 4
    samples per tile row group; rays out to radius ~7, so both branches of
    the contraction run."""
    m = _model(VANILLA, 2, cuda)
    fr.reset_launches()
    got, want, off = _k4_pair(m, _rays(*shape, 3, cuda), _radii(shape[0], 4, cuda),
                              contract)
    torch.cuda.synchronize()
    routes = fr.fused_raymarch.route_launches
    assert fr.fused_raymarch.launches == 1 and routes["ipe"] == 1
    assert routes["freq"] == routes["kplanes"] == 0
    assert routes["contract"] == int(contract)
    assert int(off.sum()) >= 0.95 * shape[0]
    for g, w, tol in zip(got, want, (2e-2, 2e-2, 2e-2, 0.1)):
        assert torch.isfinite(g).all()
        assert float((g[off] - w[off]).abs().max()) <= tol
    assert float((got[1][:, :-1] - want[1][:, :-1]).abs().max()) <= 2e-2


def test_k4_early_termination(cuda):
    m = _model(VANILLA, 6, cuda, sigma_shift=10.0)
    o, d, nr, z = _rays(2048, 192, 7, cuda)
    radii = _radii(2048, 8, cuda)
    pos_b, dir_b = vanilla_encoders()
    ed = positional_encoding(d, dir_b)
    full = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, ipe_radii=radii)
    ert = fr.fused_raymarch(m, o, d, z, nr, ed, pos_b, ipe_radii=radii,
                            ert_eps=1e-4)
    for f, e in zip(full, ert):
        assert float((f - e).abs().max()) <= 1e-3
    assert float((ert[1] == 0).float().mean()) > 0.5


def test_ipe_render_pose_on_the_card(cuda):
    mc, mf = _model(VANILLA, 8, cuda), _model(VANILLA, 9, cuda)
    pos_b, dir_b = vanilla_encoders()
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    frames = {}
    fr.reset_launches()
    for key, kw in (("kernel", dict(use_kernel=True)),
                    ("plain", dict(use_kernel=False))):
        tile = make_tile_renderer(EvalHyper(model=VANILLA, ipe=True, **kw), pos_b,
                                  dir_b, device=cuda)
        frames[key] = render_pose(tile, mc, mf, c2w, 32, 32, K, eval_chunk=300,
                                  device=cuda)
    routes = fr.fused_raymarch.route_launches
    assert routes["ipe"] == 2 * 4 and routes["freq"] == 0
    for f in frames.values():
        assert np.isfinite(f["rgb"]).all()
        assert f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0
    assert compute_psnr(frames["kernel"]["rgb"], frames["plain"]["rgb"]) >= 30.0


def test_ipe_on_cuda_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA call reached a plain version")

    monkeypatch.setattr(fr, "fused_raymarch_plain", boom)
    monkeypatch.setattr(fr, "ipe_gaussians", boom)
    m = _model(VANILLA, 4, cuda)
    o, d, nr, z = _rays(64, 32, 1, cuda)
    pos_b, dir_b = vanilla_encoders()
    for contract in (False, True):
        before = dict(fr.fused_raymarch.route_launches)
        out = fr.fused_raymarch(m, o, d, z, nr, positional_encoding(d, dir_b), pos_b,
                                ipe_radii=_radii(64, 2, cuda),
                                scene_contraction=contract)
        torch.cuda.synchronize()
        assert all(torch.isfinite(x).all() for x in out)
        after = fr.fused_raymarch.route_launches
        assert after["ipe"] == before["ipe"] + 1
        assert after["freq"] == before["freq"]
        assert after["contract"] == before["contract"] + int(contract)
    tile = make_tile_renderer(EvalHyper(model=VANILLA, nc_eval=8, nf_eval=8,
                                        ipe=True, use_kernel=True),
                              pos_b, dir_b, device=cuda)
    K = np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]], np.float32)
    out = render_pose(tile, m, m, np.eye(4, dtype=np.float32), 8, 8, K, device=cuda)
    assert np.isfinite(out["rgb"]).all()


@pytest.mark.parametrize("mode", pp.MODES)
def test_k5_matches_plain(cuda, mode):
    """Every probe shape, and M, N, K off the 16 x 32 tile and the k16 steps
    (rows not 16-byte aligned: scalar loads), and K over one 128-deep chunk
    (three round trips)."""
    rng = np.random.default_rng(3)
    ragged = [(f"{m}x{k}x{n}", rng.normal(size=(m, k)).astype(np.float32),
               rng.normal(size=(k, n)).astype(np.float32))
              for m, k, n in ((37, 21, 45), (33, 17, 40), (40, 300, 33), (1, 1, 1))]
    for name, a, b in pp.probe_inputs() + ragged:
        a, b = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
        before = pp.precision_dot.launches
        got = pp.precision_dot(a, b, mode)
        torch.cuda.synchronize()
        assert pp.precision_dot.launches == before + 1
        want = pp.precision_dot_plain(a, b, mode)
        tol = a.shape[1] * 2.0 ** -23 * (a.double().abs() @ b.double().abs())
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got.double() - want).abs() <= tol).all()), (name, mode)


def _train_setup(dev, compute, rays=256):
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec, SceneArrays
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    from nerf_sandbox_tpu_torch.train import step as ts
    rng = np.random.RandomState(0)
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]], np.float32)
    frames = []
    for i in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.3 * i, 0.0, 4.0]
        frames.append(Frame(image=rng.randint(0, 256, (24, 32, 4)).astype(np.uint8),
                            K=K, c2w=c2w))
    scene = Scene(frames)
    hyper = ts.TrainHyper(model=NeRFConfig(63, 27, n_layers=4, hidden_dim=64, skip_pos=2),
                          nc=16, nf=32, compute_dtype=compute)
    spec = RayBatchSpec(rays, 24, 32)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 100, "eta_min": 5e-6})
    pos_b, dir_b = vanilla_encoders()
    out = {}
    for d in (dev, "cpu"):
        state = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                                    generator=torch.Generator().manual_seed(1), device=d)
        out[str(torch.device(d).type)] = (
            state, SceneArrays.from_scene(scene, device=d),
            ts.build_train_step(hyper, spec, tx, pos_b, dir_b, device=d))
    return ts, hyper, spec, out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_train_step_on_card_matches_cpu(cuda, compute):
    """One step of the port's train step on the card against the same step
    on the CPU, from the same weights and the same draws (made on the card):
    the ray batch bit-equal in its targets, loss and PSNR (rtol 1e-3 fp32,
    1e-2 bf16), each gradient array within 5e-2 of its norm (a fine sample
    moved by an ulp-level change of the coarse weights moves a gradient by up
    to 2.8% of its array's norm: JAX's own jitted-versus-op-by-op spread on
    the CPU, tests/test_torch_train_step.py), the state on the card after the
    step, and no kernel launched."""
    ts, hyper, spec, out = _train_setup(cuda, compute)
    (sg, scene_g, step_g), (sc, scene_c, step_c) = out["cuda"], out["cpu"]
    draws = ts.make_draws(hyper, spec, scene_g, sg.step + 1,
                          torch.Generator(device=cuda).manual_seed(3))
    draws_c = {k: v.cpu() for k, v in draws.items()}
    from nerf_sandbox_tpu_torch.data.sampler import sample_ray_batch
    bg = sample_ray_batch(1, scene_g, spec, fids=draws["fids"], ys=draws["ys"],
                          xs=draws["xs"])
    bc = sample_ray_batch(1, scene_c, spec, fids=draws_c["fids"], ys=draws_c["ys"],
                          xs=draws_c["xs"], device="cpu")
    assert torch.equal(bg["rgb"].cpu(), bc["rgb"])
    for k in ("rays_o_marching", "rays_d_marching_unit", "radii"):
        assert float((bg[k].cpu() - bc[k]).abs().max()) <= 1e-5
    counts = (fm.fused_nerf_apply.launches, fr.fused_raymarch.launches)
    lg, mg, gg, _ = step_g.loss_and_grads(sg, scene_g, draws=draws)
    lc, mc, gc, _ = step_c.loss_and_grads(sc, scene_c, draws=draws_c)
    rtol, gtol = (1e-3, 5e-2) if compute == "float32" else (1e-2, 5e-2)
    assert abs(float(lg) / float(lc) - 1) <= rtol
    assert abs(float(ts.mse2psnr(mg)) / float(ts.mse2psnr(mc)) - 1) <= rtol
    for k in gc:
        diff = float(torch.linalg.vector_norm(gg[k].cpu() - gc[k]))
        assert diff <= gtol * float(torch.linalg.vector_norm(gc[k])) + 1e-12, k
    state, metrics = step_g(sg, scene_g, draws=draws)
    torch.cuda.synchronize()
    assert bool(metrics["finite"]) and int(state.step) == 1
    assert all(p.device.type == "cuda" for p in ts.named_params(state).values())
    assert (fm.fused_nerf_apply.launches, fr.fused_raymarch.launches) == counts


def test_train_steps_on_card_lower_the_loss(cuda):
    """Twenty steps with the step's own draws (its generator on the card):
    finite losses that fall."""
    ts, hyper, spec, out = _train_setup(cuda, "bfloat16", rays=512)
    state, scene, step = out["cuda"]
    losses = []
    for _ in range(20):
        state, m = step(state, scene)
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().numpy()
    assert np.isfinite(losses).all() and int(state.step) == 20
    assert losses[-5:].mean() < losses[:5].mean()


def test_train_chunk_graph_equals_eager_steps(cuda):
    """``build_train_step(scan_steps=4)`` on the card is one CUDA graph of 4
    steps: from copies of one state, the first call (capture and replay)
    and a second (replay only) equal 4 + 4 eager single steps, every tensor
    of the state and the last step's metrics bit for bit (two eager runs
    from one state agree bit for bit: the test checks that first)."""
    ts, hyper, spec, out = _train_setup(cuda, "bfloat16", rays=512)
    state, scene, _ = out["cuda"]
    pos_b, dir_b = vanilla_encoders()
    chunk = ts.build_train_step(hyper, spec, ts.make_optimizer(
        5e-4, "cosine", {"T_max": 100, "eta_min": 5e-6}), pos_b, dir_b,
        scan_steps=4, device=cuda)
    runs = []
    for _ in range(2):
        st = ts.clone_state(state)
        for _ in range(8):
            st, m = chunk.step(st, scene)
        runs.append((st, m))
    g = ts.clone_state(state)
    for _ in range(2):
        g, mg = chunk(g, scene)
    torch.cuda.synchronize()
    assert chunk.captures == 1 and g.host_step == 8 and int(g.step) == 8
    for st, m in runs:
        for x, y in zip(ts.state_tensors(st), ts.state_tensors(g)):
            assert torch.equal(x, y)
        for k in ("loss", "psnr", "mse_f", "finite"):
            assert torch.equal(m[k], mg[k]), k
    assert int(mg["skipped"]) == 0


HASH_F = [1, 2, 3, 4, 8, 33]


def _scatter_pairs(kind, n, F, n_rows, dev, seed=0):
    """(int32 keys, fp32 (n, F) values) on ``dev``: ``typical`` keys spread
    over the rows, ``collision`` keys on 5 rows (runs of ~n / 5, each longer
    than the kernel's unroll), ``sorted`` keys already in order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    hi = 5 if kind == "collision" else n_rows
    keys = torch.randint(0, hi, (n,), generator=g, device=dev, dtype=torch.int32)
    if kind == "sorted":
        keys = torch.sort(keys).values
    return keys, torch.randn((n, F), generator=g, device=dev)


@pytest.mark.parametrize("kind", ["typical", "collision", "sorted"])
@pytest.mark.parametrize("F", HASH_F)
@pytest.mark.parametrize("n", [1, 7, 8, 9, 100003])
def test_hash_scatter_bit_equal_to_plain(cuda, kind, F, n):
    """The table-gradient scatter (``ops/hash_scatter.py``) on the card: bit-
    equal to its plain version (``index_add_`` on CPU copies, the keys' flat
    order) and to itself on a second run, at every feature width (1 and 2
    with the values in the partition, any other width with the flat index:
    3 to 8 a lane a pair in the sum, 33 a lane a feature) and with n on
    either side of a multiple of 8; the wrapper counted once per call."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    n_rows = 4096
    keys, vals = _scatter_pairs(kind, n, F, n_rows, cuda, seed=n + F)
    before = hs.hash_scatter.launches
    a = hs.hash_scatter(keys, vals, n_rows)
    b = hs.hash_scatter(keys, vals, n_rows)
    torch.cuda.synchronize()
    assert hs.hash_scatter.launches == before + 2
    want = hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.parametrize("F", HASH_F)
@pytest.mark.parametrize("run", [127, 128, 129, 1365, 2048, 2049, 4096, 4097, 196608])
def test_hash_scatter_long_runs_bit_equal_to_plain(cuda, F, run):
    """A hot row of ``run`` pairs among 30,000 spread ones, in shuffled flat
    order (whole groups of 32 of one row, which the group's lowest lane adds
    onto the row's running sum): bit-equal to the plain version on CPU
    copies and to a second card run, with run lengths around multiples of
    the group of 32 and the stage of 256 pairs."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    n_rows = 4096
    g = torch.Generator(device=cuda).manual_seed(run + F)
    keys = torch.cat([torch.randint(0, n_rows, (30000,), generator=g, device=cuda,
                                    dtype=torch.int32),
                      torch.full((run,), 7, device=cuda, dtype=torch.int32)])
    keys = keys[torch.randperm(keys.numel(), generator=g, device=cuda)]
    vals = torch.randn((keys.numel(), F), generator=g, device=cuda)
    a = hs.hash_scatter(keys, vals, n_rows)
    b = hs.hash_scatter(keys, vals, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows))


def test_hash_scatter_skips_keys_out_of_range(cuda):
    """Keys outside [0, n_rows) are the caller's error: the plain version
    raises on them; the kernel, which cannot raise inside a capture, drops
    their pairs, short and long runs alike, and sums the rest bit-equal to
    the plain version of the pairs in range."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    n_rows = 64
    keys, vals = _scatter_pairs("typical", 1000, 2, n_rows, cuda)
    bad = torch.tensor([-1] * 300 + [n_rows] * 3 + [n_rows + 5] * 200, device=cuda,
                       dtype=torch.int32)
    keys_all = torch.cat([keys, bad])
    vals_all = torch.cat([vals, torch.randn((bad.numel(), 2), device=cuda)])
    with pytest.raises((IndexError, RuntimeError)):
        hs.hash_scatter_plain(keys_all.cpu(), vals_all.cpu(), n_rows)
    got = hs.hash_scatter(keys_all, vals_all, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows))


def test_hash_scatter_never_takes_the_plain_version(cuda, monkeypatch):
    """On CUDA tensors the wrapper launches the kernel or raises: the plain
    version is not called, and int64 keys are refused."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs

    def boom(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(hs, "hash_scatter_plain", boom)
    keys, vals = _scatter_pairs("typical", 1000, 2, 64, cuda)
    out = hs.hash_scatter(keys, vals, 64)
    assert out.device.type == "cuda" and out.shape == (64, 2)
    with pytest.raises(ValueError, match="int32"):
        hs.hash_scatter(keys.long(), vals, 64)


def test_hash_scatter_is_captured_in_a_graph(cuda):
    """The scatter inside a CUDA graph (its six kernels and its scratch on
    the capturing stream) replays bit-equal to an eager call on new values."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    keys, vals = _scatter_pairs("typical", 50000, 2, 2048, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hs.hash_scatter(keys, vals, 2048)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hs.hash_scatter(keys, vals, 2048)
    vals.copy_(torch.randn(vals.shape, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(9)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, hs.hash_scatter(keys, vals, 2048))


def _scatter_twice_and_plain(keys, vals, n_rows):
    """The card scatter twice and the plain version on CPU copies."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    a = hs.hash_scatter(keys, vals, n_rows)
    b = hs.hash_scatter(keys, vals, n_rows)
    torch.cuda.synchronize()
    return a, b, hs.hash_scatter_plain(keys.cpu(), vals.cpu(), n_rows)


@pytest.mark.parametrize("where", ["typical", "ball", "beyond"])
@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_hash_scatter_level_major_keys_bit_equal_to_plain(cuda, where, F):
    """``corner_rows``' level-major keys at 4 levels x 2^12 rows for 20,000
    points spread over the box, in a ball of radius 0.01 (a coarse level's
    pairs on 8 rows) or beyond one corner (every level's pairs on 8 rows,
    runs of 20,000): bit-equal to the plain version on CPU copies and to a
    second card run."""
    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    cfg = hg.HashGridConfig(n_levels=4, n_features=F, log2_table_size=12, base_res=4,
                            max_res=64, aabb_scale=1.5)
    rng = np.random.RandomState(F)
    if where == "typical":
        pts = rng.uniform(-1.6, 1.6, (20000, 3))
    elif where == "ball":
        d = rng.normal(size=(20000, 3))
        pts = (np.array([0.1, 0.2, 0.3]) + 0.01 * d / np.linalg.norm(d, axis=1)[:, None]
               * rng.uniform(0, 1, (20000, 1)))
    else:
        pts = rng.uniform(1.6, 3.0, (20000, 3))
    with torch.no_grad():
        keys = hg.corner_rows(torch.from_numpy(pts.astype(np.float32)).to(cuda),
                              cfg)[0].reshape(-1)
    vals = torch.randn((keys.numel(), F), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(F))
    a, b, want = _scatter_twice_and_plain(keys, vals, cfg.n_levels * cfg.table_size)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.parametrize("F", [1, 2, 3])
@pytest.mark.parametrize("n_rows", [5000, 2049, 1])
def test_hash_scatter_rows_not_a_multiple_of_the_bucket(cuda, F, n_rows):
    """A table whose rows end inside a bucket (2^11, 2^11, 2^10 rows at F =
    1, 2, 3; one row holding all 40,000 pairs): every row written into an
    output the wrapper does not fill, none past the table's end, bit-equal
    to the plain version."""
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    assert n_rows % (1 << hs.scatter_plan(1, F, n_rows).shift)
    keys, vals = _scatter_pairs("typical", 40000, F, n_rows, cuda, seed=n_rows + F)
    # NaN in the block the output is likely to reuse: a row left unwritten shows
    torch.full((n_rows, F), float("nan"), device=cuda)
    a, b, want = _scatter_twice_and_plain(keys, vals, n_rows)
    assert a.shape == (n_rows, F)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.parametrize("F", [1, 2, 3])
def test_hash_scatter_bucket_over_many_stages(cuda, F):
    """300,000 pairs in one bucket (rows 0-999 of a 2^s-row bucket, row 3
    hot), over about 1,200 stages of the sum's warp and 19 tiles of the
    partition, with a few pairs in other buckets: bit-equal to the plain
    version and to a second card run."""
    g = torch.Generator(device=cuda).manual_seed(30 + F)
    keys = torch.cat([torch.randint(0, 1000, (200000,), generator=g, device=cuda,
                                    dtype=torch.int32),
                      torch.full((100000,), 3, device=cuda, dtype=torch.int32),
                      torch.randint(0, 65536, (500,), generator=g, device=cuda,
                                    dtype=torch.int32)])
    keys = keys[torch.randperm(keys.numel(), generator=g, device=cuda)]
    vals = torch.randn((keys.numel(), F), generator=g, device=cuda)
    a, b, want = _scatter_twice_and_plain(keys, vals, 65536)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("rows", [2, 32, 33])
def test_hash_scatter_hot_bucket_split_by_row(cuda, F, rows):
    """A bucket of more than 2^15 pairs on ``rows`` rows, taken in turn as a
    clamped cell's corners are (sum_big splits a bucket of at most 32 rows
    by row across a block; 33 stays with the sum), beside a spread bucket:
    bit-equal to the plain version and to a second card run."""
    g = torch.Generator(device=cuda).manual_seed(rows + F)
    n_hot = 150000
    hot = (torch.arange(n_hot, device=cuda) % rows * 5 + 3).to(torch.int32)
    spread = torch.randint(4096, 8192, (20000,), generator=g, device=cuda,
                           dtype=torch.int32)
    keys = torch.cat([hot[:70000], spread, hot[70000:]])
    vals = torch.randn((keys.numel(), F), generator=g, device=cuda)
    a, b, want = _scatter_twice_and_plain(keys, vals, 8192)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


@pytest.mark.parametrize("F, log2", [(2, 23), (2, 24), (1, 24), (4, 22), (8, 21)])
def test_hash_scatter_large_tables_bit_equal_to_plain(cuda, F, log2):
    """The CLI's 16 levels at ``--hash_log2_size`` 21 to 24 (Instant-NGP's
    largest tables at 2^24), more rows than one pass's buckets hold, so the
    table is taken in windows: ``corner_rows``' keys of 30,000 points spread
    over the box and 2,000 beyond one corner (hot rows), bit-equal to the
    plain version on CPU copies and to a second card run, every row
    written."""
    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    cfg = hg.HashGridConfig(n_features=F, log2_table_size=log2, aabb_scale=1.5)
    n_rows = cfg.n_levels * cfg.table_size
    assert hs.scatter_plan(1, F, n_rows).windows > 1
    rng = np.random.RandomState(log2 + F)
    pts = np.concatenate([rng.uniform(-1.6, 1.6, (30000, 3)),
                          rng.uniform(1.6, 3.0, (2000, 3))]).astype(np.float32)
    with torch.no_grad():
        keys = hg.corner_rows(torch.from_numpy(pts).to(cuda), cfg)[0].reshape(-1)
    vals = torch.randn((keys.numel(), F), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(F))
    a, b, want = _scatter_twice_and_plain(keys, vals, n_rows)
    assert a.shape == (n_rows, F)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)


def test_hash_encode_backward_captured_bit_equal_to_eager(cuda):
    """The hash encode's forward and backward (the table gradient through
    the scatter) at 4 levels x 2^12 rows x 2, 7,000 points in chunks of
    3,000, captured in a CUDA graph: a replay on new output gradients is
    bit-equal to the same backward run eagerly, and the scatter launched
    once a chunk."""
    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    cfg = hg.HashGridConfig(n_levels=4, log2_table_size=12, base_res=4, max_res=64,
                            aabb_scale=1.5, chunk=3000)
    rng = np.random.RandomState(1)
    tables = torch.from_numpy(rng.uniform(-1, 1, (4, 4096, 2)).astype(np.float32)).to(
        cuda).requires_grad_(True)
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (7000, 3)).astype(np.float32)).to(cuda)
    G = torch.from_numpy(rng.normal(size=(7000, 8)).astype(np.float32)).to(cuda)
    res = hg.level_res(cfg, cuda)

    def backward():
        enc = hg.hash_encode(tables, pts, cfg, res)
        return torch.autograd.grad(enc, [tables], grad_outputs=G)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = hs.hash_scatter.launches
    with torch.cuda.graph(graph):
        got = backward()
    assert hs.hash_scatter.launches == before + 3
    G.copy_(torch.from_numpy(rng.normal(size=(7000, 8)).astype(np.float32)))
    graph.replay()
    torch.cuda.synchronize()
    want = backward()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_hash_encode_on_card_matches_cpu(cuda):
    """The hash encode at 4 levels x 2^12 rows on the card against the CPU
    within 2e-4 (the card divides by the box as a product with its
    reciprocal), and its table gradient for the same output gradient within
    1e-5 of the CPU's largest entry: the weights differ by an ulp between
    the two, so the gradients are not bit-equal."""
    from nerf_sandbox_tpu_torch.models import hashgrid as hg
    cfg = hg.HashGridConfig(n_levels=4, log2_table_size=12, base_res=4, max_res=64,
                            aabb_scale=1.5, chunk=3000)
    rng = np.random.RandomState(0)
    tables = torch.from_numpy(rng.uniform(-1, 1, (4, 4096, 2)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-1.6, 1.6, (7000, 3)).astype(np.float32))
    G = torch.from_numpy(rng.normal(size=(7000, 8)).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        t = tables.to(d).requires_grad_(True)
        enc = hg.hash_encode(t, pts.to(d), cfg)
        (g,) = torch.autograd.grad(enc, [t], grad_outputs=G.to(d))
        out[str(torch.device(d).type)] = (enc.detach().cpu(), g.cpu())
    assert float((out["cuda"][0] - out["cpu"][0]).abs().max()) <= 2e-4
    scale = float(out["cpu"][1].abs().max())
    assert float((out["cuda"][1] - out["cpu"][1]).abs().max()) <= 1e-5 * scale


def test_hash_train_chunk_graph_equals_eager_steps(cuda):
    """A hash-grid train step (4 levels x 2^12 rows, grid_lr split,
    hierarchical sampling) as a captured chunk of 4: two calls equal 8
    eager single steps from the same state, every tensor of the state
    (both models' tables included) and the metrics bit for bit, and two
    eager runs agree bit for bit; the scatter kernel launched in each
    step's backward."""
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec, SceneArrays
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    from nerf_sandbox_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_sandbox_tpu_torch.ops import hash_scatter as hs
    from nerf_sandbox_tpu_torch.train import step as ts
    rng = np.random.RandomState(0)
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]], np.float32)
    frames = []
    for i in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.3 * i, 0.0, 4.0]
        frames.append(Frame(image=rng.randint(0, 256, (24, 32, 4)).astype(np.uint8),
                            K=K, c2w=c2w))
    scene = SceneArrays.from_scene(Scene(frames), device=cuda)
    hcfg = HashGridConfig(n_levels=4, log2_table_size=12, base_res=4, max_res=64,
                          aabb_scale=1.5)
    hyper = ts.TrainHyper(model=NeRFConfig(8, 27, n_layers=4, hidden_dim=64, skip_pos=2),
                          nc=16, nf=32, pos_encoder="hashgrid", enc_cfg=hcfg)
    spec = RayBatchSpec(512, 24, 32)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 100, "eta_min": 5e-6}, grid_lr=1e-2)
    pos_b, dir_b = vanilla_encoders()
    state = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                                generator=torch.Generator().manual_seed(1), device=cuda)
    chunk = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, scan_steps=4, device=cuda)
    runs = []
    for _ in range(2):
        st = ts.clone_state(state)
        before = hs.hash_scatter.launches
        for _ in range(8):
            st, m = chunk.step(st, scene)
        assert hs.hash_scatter.launches == before + 8 * 2
        runs.append((st, m))
    g = ts.clone_state(state)
    for _ in range(2):
        g, mg = chunk(g, scene)
    torch.cuda.synchronize()
    assert chunk.captures == 1 and g.host_step == 8 and int(g.step) == 8
    for st, m in runs:
        for x, y in zip(ts.state_tensors(st), ts.state_tensors(g)):
            assert torch.equal(x, y)
        for k in ("loss", "psnr", "mse_f", "finite"):
            assert torch.equal(m[k], mg[k]), k
    assert int(mg["skipped"]) == 0
