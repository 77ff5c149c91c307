"""K2's plain PyTorch version (``ops/fused_raymarch.py``) against the JAX
fused ray-march (Pallas, interpret mode) and the JAX eval forward pass in
bf16, on the CPU: the frequency encoder at the vanilla 8x256 widths, with and
without the contraction (K2c), its integrated form (K4, mip-NeRF IPE, with
and without the contraction), and the k-planes encoder (K3; static, hybrid
with contraction, and 4-D at a fixed time) at the JAX tests' widths (planes
(8, 16) x 4, lines 32 x 8, aabb 2.0, a 4x128 MLP skip 2). The CUDA kernel is
held against this plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances are those of ``tests/test_fused_raymarch.py``: comp, weights and
acc 2e-2, depth 0.1 (bf16 accumulation order); padding independence 1e-5.
The 4-D case has a finite last bin and compares depth as Σw·z at 0.12 (the
weight tolerance times z_far), as the JAX test does: its seven-factor bf16
feature product makes per-weight noise that a low-acc depth divides up.

The infinite last bin makes a ray's output a step function of the sign of
its last sigma logit (α jumps from 0 to 1 for any logit above ~1e-8), so two
correct implementations whose logits differ by bf16 rounding disagree on a
ray whose last logit is near zero. The inputs here are checked to keep every
last logit at least ``KINK_MARGIN`` away from zero, far more than the
implementations' logit difference (the largest flipping logit seen on the
card was 0.0028).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core.encoding import positional_encoding as jpe
from nerf_sandbox_tpu.core.encoding import vanilla_encoders
from nerf_sandbox_tpu.core.integrator import volume_render_rays as jvolume
from nerf_sandbox_tpu.ops.fused_mlp import fused_nerf_apply as jfused_mlp
from nerf_sandbox_tpu.models import kplanes as jk
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.models.forward import nerf_forward_pass as jforward
from nerf_sandbox_tpu.ops.fused_raymarch import fused_raymarch as jfused
from nerf_sandbox_tpu_torch.core.encoding import (
    integrated_positional_encoding, positional_encoding, scene_contract)
from nerf_sandbox_tpu_torch.models import kplanes as tk
from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass as tforward
from nerf_sandbox_tpu_torch.models import mlp as tmlp
from nerf_sandbox_tpu_torch.ops import fused_mlp as tfm
from nerf_sandbox_tpu_torch.ops import fused_raymarch as tfr
from nerf_sandbox_tpu_torch.ops import kplanes_encode as tke

JCFG = jmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                       hidden_dim=256, skip_pos=4)
TCFG = tmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                       hidden_dim=256, skip_pos=4)
TOLS = {"comp": 2e-2, "w": 2e-2, "acc": 2e-2, "depth": 0.1}
KINK_MARGIN = 0.01


def _model(seed):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), JCFG)
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    m.load_state_dict(tmlp.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, m


def _rays(b=37, n=21, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    norms = rng.uniform(0.8, 1.3, (b,)).astype(np.float32)
    z = np.sort(rng.uniform(2.0, 6.0, (b, n)), axis=-1).astype(np.float32)
    return o, d, norms, z


def _port(m, o, d, norms, z, **kw):
    pos_b, dir_b = vanilla_encoders()
    t = torch.from_numpy
    enc_dir = positional_encoding(t(d), dir_b)
    out = tfr.fused_raymarch(m, t(o), t(d), t(z), t(norms), enc_dir, pos_b,
                             device="cpu", **kw)
    return [x.numpy() for x in out]


def _last_logit_margin(m, o, d, norms, z, contract=False, kp=None, radii=None):
    """Smallest |sigma logit| of the rays' last samples, through the plain
    versions of the encode (K4's with ``radii``) and K1."""
    pos_b, dir_b = vanilla_encoders()
    t = torch.from_numpy
    pts = t(o) + t(d) * (t(z[:, -1:]) * t(norms[:, None]))
    if contract:
        pts = scene_contract(pts)
    if radii is not None:
        mean, var = tfr.ipe_gaussians(t(o), t(d), t(z) * t(norms[:, None]),
                                      t(radii), contract)
        enc = integrated_positional_encoding(mean[:, -1], var[:, -1], pos_b)
    elif kp is None:
        enc = positional_encoding(pts, pos_b)
    else:
        enc = tke.kplanes_encode_plain(kp, pts, 128)[:, :kp.cfg.out_dim]
    out = tfm.fused_nerf_apply(m, enc, positional_encoding(t(d), dir_b),
                               device="cpu")
    return float(out[:, 3].abs().min())


def _jax_oracles(params, o, d, norms, z, **kw):
    pos_b, dir_b = vanilla_encoders()
    enc_dir = jpe(jnp.asarray(d), jnp.asarray(dir_b))
    radii = kw.get("ipe_radii")
    radii = None if radii is None else jnp.asarray(radii)
    kw = {k: v for k, v in kw.items() if k != "ipe_radii"}
    fused = jfused(params, JCFG, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                   jnp.asarray(norms), enc_dir, pos_b, interpret=True,
                   ipe_radii=radii, **kw)
    fwd = jforward(params, JCFG, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z),
                   pos_bands=jnp.asarray(pos_b), dir_bands=jnp.asarray(dir_b),
                   white_bkgd=kw.get("white_bkgd", True),
                   ray_norms=jnp.asarray(norms), viewdirs_world_unit=jnp.asarray(d),
                   sigma_activation=kw.get("sigma_activation", "relu"),
                   infinite_last_bin=kw.get("infinite_last_bin", True),
                   scene_contraction=kw.get("scene_contraction", False),
                   ipe=radii is not None, radii=radii, compute_dtype=jnp.bfloat16)
    return fused, fwd


def _assert_close(got, want, what):
    for g, w, name in zip(got, want, TOLS):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOLS[name],
                                   err_msg=f"{what}: {name}")


def test_plain_matches_jax_fused_and_forward():
    params, m = _model(0)
    rays = _rays()
    assert _last_logit_margin(m, *rays) > KINK_MARGIN
    got = _port(m, *rays)
    assert got[0].shape == (37, 3) and got[1].shape == (37, 21)
    fused, fwd = _jax_oracles(params, *rays)
    _assert_close(got, fused, "vs JAX fused_raymarch")
    _assert_close(got, fwd, "vs JAX nerf_forward_pass(bf16)")


@pytest.mark.parametrize("kw", [{"white_bkgd": False},
                                {"sigma_activation": "softplus"},
                                {"infinite_last_bin": False}],
                         ids=["black_bkgd", "softplus", "finite_last_bin"])
def test_plain_options_match_jax(kw):
    params, m = _model(1)
    rays = _rays(b=16, n=16, seed=3)
    if kw.get("infinite_last_bin", True) and "sigma_activation" not in kw:
        assert _last_logit_margin(m, *rays) > KINK_MARGIN
    got = _port(m, *rays, **kw)
    fused, fwd = _jax_oracles(params, *rays, **kw)
    _assert_close(got, fused, f"{kw} vs JAX fused_raymarch")
    _assert_close(got, fwd, f"{kw} vs JAX nerf_forward_pass(bf16)")


def test_plain_padding_independence():
    """Rays never mix: a ray's outputs do not depend on the batch around it
    (the kernel pads rays to its 16-ray blocks; the plain version chunks)."""
    _, m = _model(2)
    o, d, norms, z = _rays(b=40, n=19, seed=5)
    full = _port(m, o, d, norms, z)
    part = _port(m, o[:7], d[:7], norms[:7], z[:7])
    for f, p in zip(full, part):
        np.testing.assert_allclose(f[:7], p, atol=1e-5)


def test_deltas_and_fixup():
    z = torch.tensor([[2.0, 3.0, 5.0]])
    n = torch.tensor([2.0])
    np.testing.assert_array_equal(tfr._deltas(z, n, True).numpy(),
                                  [[2.0, 4.0, 2e10]])
    np.testing.assert_array_equal(tfr._deltas(z, n, False).numpy(),
                                  [[2.0, 4.0, 0.0]])
    raw = torch.tensor([[float("nan"), 1.5, -0.5, 0.5, 2.0]])
    comp, w, acc, depth = tfr.fixup_outputs(raw, torch.tensor([[float("inf")]]))
    np.testing.assert_array_equal(comp.numpy(), [[0.0, 1.0, 0.0]])
    assert w.item() == 0.0 and acc.item() == 0.5
    np.testing.assert_allclose(depth.numpy(), [[4.0]], rtol=1e-6)


@pytest.mark.parametrize("contract", [False, True], ids=["lift", "contracted"])
def test_ipe_matches_jax(contract):
    """K4: the plain IPE encode at b=37, n=21 (the kernel's ray and sample
    padding) with cone radii from 5e-4 (a pinhole's) to 3e-2 (which drives
    the top bands' attenuation to ~0), lifted or pushed through the
    contraction (rays out to radius ~7, so both of its branches run), against
    JAX ``fused_raymarch(ipe_radii=)`` and ``nerf_forward_pass(ipe=True)``
    (JAX tests/test_fused_raymarch.py:274-315)."""
    params, m = _model(5 + contract)
    o, d, norms, z = _rays(b=37, n=21, seed=11 + 2 * contract)
    radii = np.random.RandomState(12 + contract).uniform(5e-4, 3e-2, 37).astype(
        np.float32)
    assert _last_logit_margin(m, o, d, norms, z, contract, radii=radii) > KINK_MARGIN
    kw = dict(ipe_radii=radii, scene_contraction=contract)
    got = _port(m, o, d, norms, z, **kw)
    fused, fwd = _jax_oracles(params, o, d, norms, z, **kw)
    _assert_close(got, fused, "vs JAX fused_raymarch")
    _assert_close(got, fwd, "vs JAX nerf_forward_pass(ipe, bf16)")
    # the encode changes the result (a silently ignored radius would not),
    # and (B, 1) radii are the same as (B,)
    point = _port(m, o, d, norms, z, scene_contraction=contract)
    assert np.abs(got[0] - point[0]).max() > 1e-3
    col = _port(m, o, d, norms, z, ipe_radii=radii[:, None],
                scene_contraction=contract)
    for g, c in zip(got, col):
        np.testing.assert_array_equal(g, c)


def test_ipe_bad_inputs_raise():
    """IPE takes the frequency encoder only, one radius per ray and at least
    two samples per ray (its intervals)."""
    _, m = _model(0)
    o, d, norms, z = _rays(b=4, n=8)
    with pytest.raises(ValueError, match="ipe_radii must be"):
        _port(m, o, d, norms, z, ipe_radii=np.ones(5))
    with pytest.raises(ValueError, match="two samples"):
        _port(m, o, d, norms, z[:, :1], ipe_radii=np.ones(4))
    _, _, _, km = _kp_model(0, 0, 0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="frequency encoder only"):
        tfr.fused_raymarch(km, t(o), t(d), t(z), t(norms),
                           positional_encoding(t(d), vanilla_encoders()[1]), None,
                           kp_params=km.pos_grid, kp_cfg=km.pos_grid.cfg,
                           ipe_radii=np.ones(4), device="cpu")


def test_freq_contraction_matches_jax():
    """K2c on the frequency encoder: rays from inside the unit ball out to
    radius ~7, so both branches of the warp run (JAX
    tests/test_fused_raymarch.py:71-92)."""
    params, m = _model(2)
    rays = _rays(b=37, n=21, seed=9)
    assert _last_logit_margin(m, *rays, contract=True) > KINK_MARGIN
    got = _port(m, *rays, scene_contraction=True)
    fused, fwd = _jax_oracles(params, *rays, scene_contraction=True)
    _assert_close(got, fused, "vs JAX fused_raymarch")
    _assert_close(got, fwd, "vs JAX nerf_forward_pass(bf16)")
    # the warp changes the result (a silently ignored flag would not)
    off = _port(m, *rays)
    assert np.abs(got[0] - off[0]).max() > 1e-3


KP_CASES = {
    "static": dict(hybrid=0, time_res=0, contract=False, seed=11),
    "hybrid_contracted": dict(hybrid=3, time_res=0, contract=True, seed=12),
    "4d_fixed_time": dict(hybrid=0, time_res=6, contract=False, seed=13),
}


def _kp_model(hybrid, time_res, seed):
    """A 4x128 MLP with a k-planes grid at the JAX tests' widths; tables
    N(1, 0.1), 4-D time planes N(1, 0.3) so that time modulates the field."""
    jkc = jk.KPlanesConfig(plane_res=(8, 16), plane_features=4, line_res=32,
                           line_features=8, aabb_scale=2.0, hybrid_freqs=hybrid,
                           time_res=time_res)
    jcfg = jmlp.NeRFConfig(jkc.out_dim, 27, n_layers=4, hidden_dim=128,
                           skip_pos=2)
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    grid = {}
    for k, v in jk.init_kplanes_params(jax.random.PRNGKey(0), jkc).items():
        std = 0.3 if k.split("_")[-1] in ("xt", "yt", "zt") else 0.1
        grid[k] = (1.0 + std * rng.normal(size=v.shape)).astype(np.float32)
    params["pos_grid"] = grid
    m = tmlp.NeRFMLP(tmlp.NeRFConfig(*jcfg), grid_cfg=tk.KPlanesConfig(*jkc),
                     device="cpu")
    m.load_state_dict(tmlp.params_from_jax(params))
    return params, jcfg, jkc, m


@pytest.mark.parametrize("case", KP_CASES)
def test_kplanes_matches_jax(case):
    c = KP_CASES[case]
    params, jcfg, jkc, m = _kp_model(c["hybrid"], c["time_res"], c["seed"])
    o, d, norms, z = _rays(b=37, n=21, seed=c["seed"])
    dyn = c["time_res"] > 0
    t_frame = 0.37 if dyn else None
    kw = dict(infinite_last_bin=not dyn, scene_contraction=c["contract"])
    if not dyn:
        kp = tke.pack_kplanes(m.pos_grid, m.pos_grid.cfg)
        assert _last_logit_margin(m, o, d, norms, z, c["contract"], kp) > KINK_MARGIN
    pos_b, dir_b = vanilla_encoders()
    t = torch.from_numpy
    got = tfr.fused_raymarch(m, t(o), t(d), t(z), t(norms),
                             positional_encoding(t(d), dir_b), None,
                             kp_params=m.pos_grid, kp_cfg=m.pos_grid.cfg,
                             kp_t=t_frame, device="cpu", **kw)
    got = [x.numpy() for x in got]
    J = jnp.asarray
    fused = jfused(params, jcfg, J(o), J(d), J(z), J(norms),
                   jpe(J(d), J(dir_b)), None, kp_params=params["pos_grid"],
                   kp_cfg=jkc, kp_t=None if t_frame is None else jnp.float32(t_frame),
                   interpret=True, **kw)
    fwd = jforward(params, jcfg, J(o), J(d), J(z), pos_bands=jnp.zeros((0,)),
                   dir_bands=J(dir_b), white_bkgd=True, ray_norms=J(norms),
                   viewdirs_world_unit=J(d), pos_encoder="kplanes", enc_cfg=jkc,
                   t=None if t_frame is None else jnp.full((37,), t_frame),
                   compute_dtype=jnp.bfloat16, **kw)
    for want, what in ((fused, "vs JAX fused_raymarch"),
                       (fwd, "vs JAX nerf_forward_pass(bf16)")):
        want = [np.asarray(w) for w in want]
        if dyn:   # depth as the raw composite sum of w·z
            got[3], want[3] = got[3] * got[2], want[3] * want[2]
            for g, w, name, tol in zip(got, want, TOLS, (2e-2, 2e-2, 2e-2, 0.12)):
                np.testing.assert_allclose(g, w, atol=tol, err_msg=f"{what}: {name}")
            got[3] = got[3] / got[2]
        else:
            _assert_close(got, want, what)
    if dyn:   # the frame time moves the field
        other = tfr.fused_raymarch(m, t(o), t(d), t(z), t(norms),
                                   positional_encoding(t(d), dir_b), None,
                                   kp_params=m.pos_grid, kp_cfg=m.pos_grid.cfg,
                                   kp_t=0.9, device="cpu", **kw)
        assert float((other[0] - torch.from_numpy(got[0])).abs().max()) > 1e-3


@pytest.mark.parametrize("hybrid", [0, 3])
def test_plain_kplanes_four_features_matches_jax_pallas(hybrid):
    """K2's k-planes route at plane_features = 4 (which the kernels now take)
    against the Pallas kernel in interpret mode, on the JAX test's own
    configuration and init (tests/test_fused_raymarch.py:_kp_setup: planes
    (8, 16) x 4, lines 32 x 8, aabb 2.0, a 4x128 MLP skip 2)."""
    jkc = jk.KPlanesConfig(plane_res=(8, 16), plane_features=4, line_res=32,
                           line_features=8, aabb_scale=2.0, hybrid_freqs=hybrid)
    jcfg = jmlp.NeRFConfig(jkc.out_dim, 27, n_layers=4, hidden_dim=128, skip_pos=2)
    key = jax.random.PRNGKey(4)
    params = jmlp.init_nerf_params(key, jcfg)
    params["pos_grid"] = jk.init_kplanes_params(jax.random.fold_in(key, 1), jkc)
    params = jax.tree_util.tree_map(np.asarray, params)
    m = tmlp.NeRFMLP(tmlp.NeRFConfig(*jcfg), grid_cfg=tk.KPlanesConfig(*jkc),
                     device="cpu")
    m.load_state_dict(tmlp.params_from_jax(params))
    o, d, norms, z = _rays(b=37, n=21, seed=11)
    kp = tke.pack_kplanes(m.pos_grid, m.pos_grid.cfg)
    assert _last_logit_margin(m, o, d, norms, z, False, kp) > KINK_MARGIN
    _, dir_b = vanilla_encoders()
    t = torch.from_numpy
    got = tfr.fused_raymarch(m, t(o), t(d), t(z), t(norms),
                             positional_encoding(t(d), dir_b), None, kp_params=kp,
                             kp_cfg=kp.cfg,
                             device="cpu")
    J = jnp.asarray
    want = jfused(params, jcfg, J(o), J(d), J(z), J(norms), jpe(J(d), J(dir_b)),
                  None, kp_params=params["pos_grid"], kp_cfg=jkc, interpret=True)
    _assert_close([x.numpy() for x in got], want, "vs JAX fused_raymarch")


def test_4d_forward_pass_with_per_ray_times_matches_jax():
    """A 4-D k-planes ``nerf_forward_pass(use_kernel=True)`` whose rays carry
    two different times: the encode runs per sample (JAX runs no kernel for
    it either), the MLP through K1. Held against JAX's own steps:
    ``kplanes_encode(t01)`` in bf16, ``fused_nerf_apply(interpret=True)``,
    ``volume_render_rays``; rgb and acc 2e-2, depth 0.1 (finite last bin)."""
    params, jcfg, jkc, m = _kp_model(0, 6, 14)
    o, d, norms, z = _rays(b=37, n=21, seed=14)
    times = np.where(np.arange(37) % 2 == 0, 0.2, 0.8).astype(np.float32)
    pos_b, dir_b = vanilla_encoders()
    t = torch.from_numpy
    got = tforward(m, t(o), t(d), t(z), pos_bands=pos_b, dir_bands=dir_b,
                   white_bkgd=True, ray_norms=t(norms), viewdirs_world_unit=t(d),
                   infinite_last_bin=False, compute_dtype=torch.bfloat16,
                   use_kernel=True, pos_encoder="kplanes", enc_cfg=m.pos_grid.cfg,
                   t=t(times), device="cpu")
    J = jnp.asarray
    pts = (o[:, None, :] + d[:, None, :] * (z * norms[:, None])[..., None]).reshape(-1, 3)
    t01 = np.repeat(times, z.shape[1])
    enc_pos = jk.kplanes_encode(jax.tree_util.tree_map(J, params["pos_grid"]), J(pts),
                                jkc, compute_dtype=jnp.bfloat16, t01=J(t01))
    enc_dir = jpe(J(np.repeat(d, z.shape[1], axis=0)), J(dir_b))
    raw = jfused_mlp(params, jcfg, enc_pos, enc_dir, interpret=True)
    rgb = jax.nn.sigmoid(raw[:, :3]).reshape(37, -1, 3)
    sigma = jax.nn.relu(raw[:, 3]).reshape(37, -1)
    want = jvolume(rgb, sigma, J(z), ray_norm=J(norms), white_bkgd=True,
                   infinite_last_bin=False)
    got = [x.detach().numpy() for x in got]
    for g, w, name, tol in zip(got, want, TOLS, (2e-2, 2e-2, 2e-2, 0.1)):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, err_msg=name)
    # the times reach the encode: one shared time gives another result
    same = tforward(m, t(o), t(d), t(z), pos_bands=pos_b, dir_bands=dir_b,
                    white_bkgd=True, ray_norms=t(norms), viewdirs_world_unit=t(d),
                    infinite_last_bin=False, compute_dtype=torch.bfloat16,
                    use_kernel=True, pos_encoder="kplanes", enc_cfg=m.pos_grid.cfg,
                    t=t(np.full(37, 0.2, np.float32)), device="cpu")
    same = same[0].detach().numpy()
    assert np.abs(same - got[0]).max() > 1e-3
    np.testing.assert_allclose(same[::2], got[0][::2], atol=2e-2)
