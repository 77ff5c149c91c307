"""The port's eval renderer (``render_pose``) against the JAX renderer on the
CPU: 12x12 pixels in 64-ray tiles (so the last tile is wrap-padded), 8
coarse + 16 fine samples, a 3x128 skip MLP.

Tolerances: the fp32 plain path against JAX ``use_pallas=False`` at rgb/acc
1e-4 and depth 1e-3 (fp32 both sides; summation order); the bf16 kernel twin
(K2's plain version) against JAX ``use_pallas=True`` in interpret mode at
rgb/acc 2e-2 and depth 0.1 (the fused ray-march tests' bf16 bounds).

Hierarchical sampling is ill-conditioned on a raw random-init field: its
thin, sharp density gives CDF bins of small mass, and a sample landing in
one moves by (change in coarse weights) / (bin mass). A bf16-level change in
the coarse weights (1e-3) then moves fine samples by ~3e-2 and the
composite by ~6e-2, and an fp32-level one (1e-7) moves them by ~4e-6, which
the 2^9 top encode band turns into ~3e-3 of rgb. Both implementations are
right; they are not comparable there. So the raw-init models are compared
through the coarse pass alone, and the full hierarchical render on a smooth
dense field (sigma head x0.5, bias +0.5), where the sampler is well
conditioned. Every case also keeps the last sigma logit away from the
infinite last bin's step (``KINK_MARGIN``).

The contracted k-planes-hybrid configuration (the unbounded-360 one: planes
(8, 16) x 4, lines 32 x 8, hybrid 3, aabb 2.0, ``scene_contraction``,
``lindisp``, near 0.125 / far 22.5, an orbit at radius 1) is held the same
way, and a 4-D grid through ``render_pose(time=...)`` with a finite last bin.
So is mip-NeRF's integrated positional encoding (``ipe``, the pixel-cone
radii from ``render_pose``), with the kink margin taken on the last
sample's frustum Gaussian of each pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core.encoding import vanilla_encoders
from nerf_sandbox_tpu.models import kplanes as jk
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.render import renderer as jr
from nerf_sandbox_tpu_torch.core.encoding import (
    integrated_positional_encoding, pixel_cone_radii, positional_encoding,
    scene_contract)
from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
from nerf_sandbox_tpu_torch.core.sampling import (
    merge_z_samples, resample_midpoints, stratified_samples)
from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass as tfwd
from nerf_sandbox_tpu_torch.models import kplanes as tk
from nerf_sandbox_tpu_torch.models import mlp as tmlp
from nerf_sandbox_tpu_torch.ops import fused_mlp as tfm
from nerf_sandbox_tpu_torch.ops import fused_raymarch as tfr
from nerf_sandbox_tpu_torch.ops import kplanes_encode as tke
from nerf_sandbox_tpu_torch.render import renderer as tr

JCFG = jmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=128, skip_pos=1)
TCFG = tmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=128, skip_pos=1)
H = W = 12
KMAT = np.array([[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]], np.float32)
KINK_MARGIN = 0.01        # see tests/test_torch_fused_raymarch.py


def _pose(th=0.0):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
    return c2w


SMOOTH = dict(scale_sigma=0.5, shift_sigma=0.5)
CASES = {"raw_init_coarse_only": dict(models={}, nf_eval=0, th=0.0),
         "smooth_field_hierarchical": dict(models=SMOOTH, nf_eval=16, th=0.4)}


def _models(scale_sigma=None, shift_sigma=0.0):
    out = []
    for seed in (0, 1):
        p = jmlp.init_nerf_params(jax.random.PRNGKey(seed), JCFG)
        if scale_sigma is not None:
            p["sigma_out"]["w"] = p["sigma_out"]["w"] * scale_sigma
            p["sigma_out"]["b"] = p["sigma_out"]["b"] + shift_sigma
        m = tmlp.NeRFMLP(TCFG, device="cpu")
        m.load_state_dict(tmlp.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p)))
        out.append((p, m))
    return out


def _last_logit_margin(models, c2w):
    """Smallest |sigma logit| at z = far over all pixels and both models:
    both passes end on a sample there (see the kink note above)."""
    pos_b, dir_b = vanilla_encoders()
    rays = get_camera_rays_grid(torch.from_numpy(KMAT), torch.from_numpy(c2w),
                                image_h=H, image_w=W, pixel_center=True)
    pts = rays.o_march + rays.d_march_unit * (6.0 * rays.d_march_norm)
    enc_p = positional_encoding(pts, pos_b)
    enc_d = positional_encoding(rays.d_world_unit, dir_b)
    with torch.no_grad():
        return min(float(m(enc_p, enc_d, compute_dtype=dt)[:, 3].abs().min())
                   for _, m in models for dt in (None, torch.bfloat16))


def _render_both(models, c2w, *, jax_kw, port_kw, nf_eval=16):
    pos_b, dir_b = vanilla_encoders()
    (pc, mc), (pf, mf) = models
    if not nf_eval:
        pf = mf = None
    jtile = jr.make_tile_renderer(
        jr.EvalHyper(model=JCFG, nc_eval=8, nf_eval=nf_eval, **jax_kw),
        jnp.asarray(pos_b), jnp.asarray(dir_b))
    want = jr.render_pose(jtile, pc, pf, c2w, H, W, KMAT, eval_chunk=64)
    ttile = tr.make_tile_renderer(
        tr.EvalHyper(model=TCFG, nc_eval=8, nf_eval=nf_eval, **port_kw),
        pos_b, dir_b, device="cpu")
    got = tr.render_pose(ttile, mc, mf, c2w, H, W, KMAT, eval_chunk=64,
                         device="cpu")
    return got, want


@pytest.mark.parametrize("case", CASES)
def test_fp32_plain_path_matches_jax(case):
    c = CASES[case]
    models = _models(**c["models"])
    c2w = _pose(c["th"])
    assert _last_logit_margin(models, c2w) > KINK_MARGIN
    got, want = _render_both(models, c2w, nf_eval=c["nf_eval"],
                             jax_kw=dict(compute_dtype="float32"),
                             port_kw=dict(compute_dtype="float32"))
    assert got["rgb"].shape == (H, W, 3) and got["depth"].shape == (H, W, 1)
    for key, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    assert got["rgb"].std() > 1e-2        # a non-trivial image


@pytest.mark.parametrize("case", CASES)
def test_bf16_kernel_twin_matches_jax_fused(case):
    c = CASES[case]
    models = _models(**c["models"])
    c2w = _pose(c["th"])
    assert _last_logit_margin(models, c2w) > KINK_MARGIN
    got, want = _render_both(
        models, c2w, nf_eval=c["nf_eval"],
        jax_kw=dict(use_pallas=True, pallas_interpret=True),
        port_kw=dict(use_kernel=True))
    for key, tol in (("rgb", 2e-2), ("acc", 2e-2), ("depth", 0.1)):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)


def test_fine_frac_culling_matches_jax():
    """``eval_fine_frac`` keeps the coarse composite on the culled rays and
    refines the top-K by coarse opacity, as the JAX renderer does (softplus
    sigma and a finite last bin give distinct opacities, so the top-K cut
    is unambiguous)."""
    models = _models(scale_sigma=0.5, shift_sigma=-1.0)
    kw = dict(compute_dtype="float32", eval_fine_frac=0.5,
              sigma_activation="softplus", infinite_last_bin=False)
    got, want = _render_both(models, _pose(0.9), jax_kw=kw, port_kw=kw,
                             nf_eval=8)
    for key, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)


def test_chunked_equals_single_tile():
    (_, mc), (_, mf) = _models()
    hyper = tr.EvalHyper(model=TCFG, nc_eval=8, nf_eval=8,
                         compute_dtype="float32")
    pos_b, dir_b = vanilla_encoders()
    tile = tr.make_tile_renderer(hyper, pos_b, dir_b, device="cpu")
    rng = np.random.RandomState(0)
    ro = torch.from_numpy(rng.normal(size=(100, 3)).astype(np.float32))
    rd = ro / ro.norm(dim=-1, keepdim=True)
    rn = torch.ones(100, 1)
    small = tr.render_rays_chunked(tile, mc, mf, ro, rd, rn, rd, eval_chunk=32,
                                   device="cpu")
    big = tr.render_rays_chunked(tile, mc, mf, ro, rd, rn, rd, eval_chunk=128,
                                 device="cpu")
    assert small["rgb"].shape == (100, 3)
    for k in small:
        np.testing.assert_allclose(small[k].numpy(), big[k].numpy(), atol=1e-5)
    coarse = tr.render_rays_chunked(tile, mc, None, ro, rd, rn, rd,
                                    eval_chunk=64, device="cpu")
    assert coarse["rgb"].shape == (100, 3)


def test_perturbed_render_is_seeded():
    (_, mc), (_, mf) = _models()
    pos_b, dir_b = vanilla_encoders()
    tile = tr.make_tile_renderer(
        tr.EvalHyper(model=TCFG, nc_eval=8, nf_eval=8, perturb=True),
        pos_b, dir_b, device="cpu")
    outs = [tr.render_pose(tile, mc, mf, _pose(), 4, 4, KMAT, device="cpu",
                           generator=torch.Generator().manual_seed(s))["rgb"]
            for s in (0, 0, 1)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


@pytest.mark.parametrize("kw,match", [
    ({"sampling_mode": "occupancy"}, "P7 item 3"),
    ({"sampling_mode": "proposal"}, "P7 item 4"),
    ({"pos_encoder": "hashgrid"}, "P7 item 8"),
    ({"ipe": True, "pos_encoder": "kplanes"}, "IPE applies to the freq encoder"),
    ({"dir_encoder": "sh"}, "P7 item 6"),
])
def test_unported_modes_raise(kw, match):
    """Unported modes raise NotImplementedError naming their queue item;
    IPE with another encoder than ``freq`` is refused (ValueError)."""
    pos_b, dir_b = vanilla_encoders()
    exc = ValueError if kw.get("ipe") else NotImplementedError
    with pytest.raises(exc, match=match):
        tr.make_tile_renderer(tr.EvalHyper(model=TCFG, **kw), pos_b, dir_b,
                              device="cpu")


def test_tile_device_mismatch_raises():
    pos_b, dir_b = vanilla_encoders()
    tile = tr.make_tile_renderer(tr.EvalHyper(model=TCFG), pos_b, dir_b,
                                 device="cpu")
    tile.device = torch.device("meta")
    (_, mc), (_, mf) = _models()
    with pytest.raises(ValueError, match="tile renderer runs on"):
        tr.render_pose(tile, mc, mf, _pose(), 2, 2, KMAT, device="cpu")


def _kp_models(time_res=0, hybrid=3, smooth=False):
    """JAX params and the port's models of the k-planes configuration: a
    3x128 MLP (skip 1) with a grid of N(1, 0.1) tables (4-D time planes
    N(1, 0.3)), seeds 0 and 1."""
    jkc = jk.KPlanesConfig(plane_res=(8, 16), plane_features=4, line_res=32,
                           line_features=8, aabb_scale=2.0, hybrid_freqs=hybrid,
                           time_res=time_res)
    jcfg = jmlp.NeRFConfig(jkc.out_dim, 27, n_layers=3, hidden_dim=128,
                           skip_pos=1)
    out = []
    for seed in (0, 1):
        p = jax.tree_util.tree_map(
            np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), jcfg))
        if smooth:
            p["sigma_out"]["w"] = p["sigma_out"]["w"] * 0.5
            p["sigma_out"]["b"] = p["sigma_out"]["b"] + 0.5
        rng = np.random.RandomState(10 + seed)
        p["pos_grid"] = {
            k: (1.0 + (0.3 if k.split("_")[-1] in ("xt", "yt", "zt") else 0.1)
                * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in jk.init_kplanes_params(jax.random.PRNGKey(0), jkc).items()}
        m = tmlp.NeRFMLP(tmlp.NeRFConfig(*jcfg), grid_cfg=tk.KPlanesConfig(*jkc),
                         device="cpu")
        m.load_state_dict(tmlp.params_from_jax(p))
        out.append((p, m))
    return jkc, jcfg, out


def _orbit_360(th):
    """The mip-NeRF 360 "norm" frame: an orbit at radius 1 (RESULTS.md)."""
    c2w = _pose(th)
    c2w[:3, 3] /= 4.0
    return c2w


def _kp_last_logit_margin(models, c2w, far, time=None):
    """Smallest |sigma logit| at z = far over all pixels, both models and
    every encode the compared paths use: fp32 and bf16 ``kplanes_encode``
    with the MLP in that type, and K3's plain version with K1's."""
    _, dir_b = vanilla_encoders()
    rays = get_camera_rays_grid(torch.from_numpy(KMAT), torch.from_numpy(c2w),
                                image_h=H, image_w=W, pixel_center=True)
    pts = scene_contract(rays.o_march + rays.d_march_unit * (far * rays.d_march_norm))
    enc_d = positional_encoding(rays.d_world_unit, dir_b)
    t01 = None if time is None else torch.full((H * W,), float(time))
    out = []
    with torch.no_grad():
        for _, m in models:
            cfg = m.pos_grid.cfg
            for dt in (None, torch.bfloat16):
                enc = m.pos_grid(pts, compute_dtype=dt, t01=t01)
                out.append(float(m(enc, enc_d, compute_dtype=dt)[:, 3].abs().min()))
            kp = tke.pack_kplanes(m.pos_grid, cfg, t=time)
            enc = tke.kplanes_encode_plain(kp, pts, 128)[:, :cfg.out_dim]
            out.append(float(tfm.fused_nerf_apply(m, enc, enc_d, device="cpu")
                             [:, 3].abs().min()))
    return min(out)


KP_360 = dict(samp_near=0.125, samp_far=22.5, lindisp=True,
              scene_contraction=True, pos_encoder="kplanes")
KP_PATHS = {"fp32_plain": (dict(compute_dtype="float32"),
                           dict(compute_dtype="float32"), (1e-4, 1e-4, 1e-3)),
            "bf16_kernel_twin": (dict(use_pallas=True, pallas_interpret=True),
                                 dict(use_kernel=True), (2e-2, 2e-2, 0.1))}
KP_FIELDS = {"raw_init_coarse_only": dict(smooth=False, nf_eval=0, th=0.0),
             "smooth_field_hierarchical": dict(smooth=True, nf_eval=16, th=1.1)}


def _kp_render_both(models, jkc, jcfg, c2w, nf_eval, jax_kw, port_kw, time=None,
                    **hyper):
    _, dir_b = vanilla_encoders()
    (pc, mc), (pf, mf) = models
    if not nf_eval:
        pf = mf = None
    jtile = jr.make_tile_renderer(
        jr.EvalHyper(model=jcfg, nc_eval=8, nf_eval=nf_eval, enc_cfg=jkc,
                     **hyper, **jax_kw), jnp.zeros((0,)), jnp.asarray(dir_b))
    want = jr.render_pose(jtile, pc, pf, c2w, H, W, KMAT, eval_chunk=64,
                          time=time)
    ttile = tr.make_tile_renderer(
        tr.EvalHyper(model=tmlp.NeRFConfig(*jcfg), nc_eval=8, nf_eval=nf_eval,
                     enc_cfg=tk.KPlanesConfig(*jkc), **hyper, **port_kw),
        np.zeros(0, np.float32), dir_b, device="cpu")
    got = tr.render_pose(ttile, mc, mf, c2w, H, W, KMAT, eval_chunk=64,
                         time=time, device="cpu")
    return got, want


@pytest.mark.parametrize("field", KP_FIELDS)
@pytest.mark.parametrize("path", KP_PATHS)
def test_contracted_kplanes_hybrid_matches_jax(path, field):
    """The unbounded-360 configuration: k-planes + hybrid channels + scene
    contraction + disparity-linear samples, plain and kernel-twin paths."""
    f = KP_FIELDS[field]
    jax_kw, port_kw, tols = KP_PATHS[path]
    jkc, jcfg, models = _kp_models(smooth=f["smooth"])
    c2w = _orbit_360(f["th"])
    assert _kp_last_logit_margin(models, c2w, KP_360["samp_far"]) > KINK_MARGIN
    got, want = _kp_render_both(models, jkc, jcfg, c2w, f["nf_eval"], jax_kw,
                                port_kw, **KP_360)
    for key, tol in zip(("rgb", "acc", "depth"), tols):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    assert got["rgb"].std() > 1e-2


@pytest.mark.parametrize("path", KP_PATHS)
def test_4d_render_pose_at_a_time_matches_jax(path):
    """``render_pose(time=...)`` on a 4-D grid (time_res 6, no hybrid, no
    contraction) with a finite last bin; a second time gives another frame."""
    jax_kw, port_kw, tols = KP_PATHS[path]
    jkc, jcfg, models = _kp_models(time_res=6, hybrid=0, smooth=True)
    hyper = dict(pos_encoder="kplanes", infinite_last_bin=False)
    got, want = _kp_render_both(models, jkc, jcfg, _pose(0.7), 16, jax_kw,
                                port_kw, time=0.37, **hyper)
    for key, tol in zip(("rgb", "acc", "depth"), tols):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    later, _ = _kp_render_both(models, jkc, jcfg, _pose(0.7), 16, jax_kw,
                               port_kw, time=0.9, **hyper)
    assert np.abs(later["rgb"] - got["rgb"]).max() > 1e-3
    ttile = tr.make_tile_renderer(
        tr.EvalHyper(model=tmlp.NeRFConfig(*jcfg), enc_cfg=tk.KPlanesConfig(*jkc),
                     **hyper, **port_kw), np.zeros(0, np.float32),
        vanilla_encoders()[1], device="cpu")
    with pytest.raises(ValueError, match="time"):
        tr.render_pose(ttile, models[0][1], models[1][1], _pose(), 2, 2, KMAT,
                       device="cpu")


def test_kplanes_hyper_is_checked():
    jkc, jcfg, _ = _kp_models()
    cfg = tmlp.NeRFConfig(*jcfg)
    _, dir_b = vanilla_encoders()
    for kw in (dict(), dict(enc_cfg=tk.KPlanesConfig(*jkc)._replace(hybrid_freqs=1))):
        with pytest.raises(ValueError, match="enc_cfg|out_dim"):
            tr.make_tile_renderer(tr.EvalHyper(model=cfg, pos_encoder="kplanes",
                                               **kw), None, dir_b, device="cpu")


def _ipe_last_logit_margin(models, c2w, nf_eval):
    """Smallest |sigma logit| of the last sample of each pass, over all
    pixels, encoded as that sample's frustum Gaussian: the coarse pass's
    uniform z, and the fine pass's merged z from the port's fp32 coarse
    pass; the MLP in fp32 and in bf16."""
    pos_b, dir_b = vanilla_encoders()
    rays = get_camera_rays_grid(torch.from_numpy(KMAT), torch.from_numpy(c2w),
                                image_h=H, image_w=W, pixel_center=True)
    ro, rd, rn = rays.o_march, rays.d_march_unit, rays.d_march_norm
    radii = pixel_cone_radii(torch.tensor(KMAT[0, 0]), rays.d_world_norm[..., 0])
    enc_d = positional_encoding(rays.d_world_unit, dir_b)
    (_, mc), (_, mf) = models
    zs = [stratified_samples(2.0, 6.0, 8).expand(H * W, 8)]
    with torch.no_grad():
        if nf_eval:
            _, w, _, _ = tfwd(mc, ro, rd, zs[0], pos_bands=pos_b, dir_bands=dir_b,
                              white_bkgd=True, ray_norms=rn,
                              viewdirs_world_unit=rays.d_world_unit,
                              infinite_last_bin=True, ipe=True, radii=radii,
                              device="cpu")
            zs.append(merge_z_samples(zs[0], resample_midpoints(
                zs[0], w, nf_eval, deterministic=True)))
        out = []
        for m, z in zip((mc, mf), zs):
            mean, var = tfr.ipe_gaussians(ro, rd, z * rn, radii, False)
            enc = integrated_positional_encoding(mean[:, -1], var[:, -1], pos_b)
            out += [float(m(enc, enc_d, compute_dtype=dt)[:, 3].abs().min())
                    for dt in (None, torch.bfloat16)]
    return min(out)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("path", KP_PATHS)
def test_ipe_render_pose_matches_jax(path, case):
    """mip-NeRF IPE through ``render_pose``: the plain fp32 path against JAX
    ``use_pallas=False`` and the kernel twin (K4's plain version) against
    JAX ``use_pallas`` in interpret mode, raw-init coarse-only and on the
    smooth field with the fine pass."""
    c = CASES[case]
    jax_kw, port_kw, tols = KP_PATHS[path]
    models = _models(**c["models"])
    c2w = _pose(c["th"])
    assert _ipe_last_logit_margin(models, c2w, c["nf_eval"]) > KINK_MARGIN
    got, want = _render_both(models, c2w, nf_eval=c["nf_eval"],
                             jax_kw=dict(ipe=True, **jax_kw),
                             port_kw=dict(ipe=True, **port_kw))
    for key, tol in zip(("rgb", "acc", "depth"), tols):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    assert got["rgb"].std() > 1e-2


def test_ipe_fine_frac_culling_matches_jax():
    """``eval_fine_frac`` with IPE: the refined rays take their own radii
    (``radii[top]``), as in the JAX renderer."""
    models = _models(scale_sigma=0.5, shift_sigma=-1.0)
    kw = dict(compute_dtype="float32", eval_fine_frac=0.5, ipe=True,
              sigma_activation="softplus", infinite_last_bin=False)
    got, want = _render_both(models, _pose(0.9), jax_kw=kw, port_kw=kw,
                             nf_eval=8)
    for key, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    # the encode is live on this path: without IPE the frame differs
    radii_free, _ = _render_both(models, _pose(0.9), jax_kw=kw,
                                 port_kw={**kw, "ipe": False}, nf_eval=8)
    assert np.abs(radii_free["rgb"] - got["rgb"]).max() > 1e-3


def test_ipe_needs_radii_and_no_ndc():
    (_, mc), (_, mf) = _models()
    pos_b, dir_b = vanilla_encoders()
    tile = tr.make_tile_renderer(tr.EvalHyper(model=TCFG, nc_eval=4, nf_eval=4,
                                              ipe=True), pos_b, dir_b, device="cpu")
    with pytest.raises(ValueError, match="NDC"):
        tr.render_pose(tile, mc, mf, _pose(), 2, 2, KMAT, use_ndc=True,
                       device="cpu")
    ro = torch.zeros(2, 3)
    rd = torch.tensor([[0.0, 0.0, -1.0]] * 2)
    with pytest.raises(ValueError, match="radii"):
        tile(mc, mf, ro, rd, torch.ones(2, 1), rd)
    out = tile(mc, mf, ro, rd, torch.ones(2, 1), rd, radii=torch.full((2,), 1e-3))
    assert all(torch.isfinite(x).all() for x in out)
