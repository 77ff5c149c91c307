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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core.encoding import vanilla_encoders
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.render import renderer as jr
from nerf_sandbox_tpu_torch.core.encoding import positional_encoding
from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
from nerf_sandbox_tpu_torch.models import mlp as tmlp
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
    ({"pos_encoder": "kplanes"}, "P7 item 2"),
    ({"pos_encoder": "hashgrid"}, "P7 item 8"),
    ({"scene_contraction": True}, "K2c"),
    ({"ipe": True}, "K4"),
    ({"dir_encoder": "sh"}, "P7 item 6"),
])
def test_unported_modes_raise(kw, match):
    pos_b, dir_b = vanilla_encoders()
    with pytest.raises(NotImplementedError, match=match):
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
