"""The port's core/ (rays, encoding, sampling, integrator) against the JAX
package and the torch reference's golden outputs, on the CPU.

Inputs are made with numpy and handed to both sides. Tolerance: 1e-5 absolute
against the JAX functions (both sides fp32; the difference is summation
order), and the JAX tests' own tolerances against the golden fixtures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core import encoding as jenc
from nerf_sandbox_tpu.core import integrator as jint
from nerf_sandbox_tpu.core import rays as jrays
from nerf_sandbox_tpu.core import sampling as jsamp
from nerf_sandbox_tpu_torch.core import encoding as tenc
from nerf_sandbox_tpu_torch.core import integrator as tint
from nerf_sandbox_tpu_torch.core import rays as trays
from nerf_sandbox_tpu_torch.core import sampling as tsamp

ATOL = 1e-5
FIELDS = ["o_world", "d_world_unit", "d_world_norm",
          "o_march", "d_march_unit", "d_march_norm"]


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _pose(seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-np.pi, np.pi, 3)
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    R = (np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = rng.uniform(-4, 4, 3)
    return c2w


# ---------------- rays ----------------

@pytest.mark.parametrize("conv", ["opengl", "opencv", "pytorch3d"])
def test_world_rays_match_jax_and_golden(golden, conv):
    K, c2w, px = golden["rays_K"], golden["rays_c2w"], golden["rays_pixels"]
    H, W = int(golden["rays_H"]), int(golden["rays_W"])
    kw = dict(image_h=H, image_w=W, convention=conv, pixel_center=True,
              as_ndc=False)
    got = trays.get_camera_rays(t(K), t(c2w), t(px), **kw)
    want = jrays.get_camera_rays(jnp.asarray(K), jnp.asarray(c2w),
                                 jnp.asarray(px), **kw)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"{conv}/{name} vs JAX")
        np.testing.assert_allclose(g.numpy(), golden[f"rays_{conv}_{name}"],
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{conv}/{name} vs golden")


def test_ndc_rays_match_jax_and_golden(golden):
    K, c2w, px = golden["rays_K"], golden["rays_ndc_c2w"], golden["rays_pixels"]
    H, W = int(golden["rays_H"]), int(golden["rays_W"])
    kw = dict(image_h=H, image_w=W, convention="opengl", pixel_center=True,
              as_ndc=True, near_plane=1.0)
    got = trays.get_camera_rays(t(K), t(c2w), t(px), **kw)
    want = jrays.get_camera_rays(jnp.asarray(K), jnp.asarray(c2w),
                                 jnp.asarray(px), **kw)
    for name, g, w in zip(FIELDS, got, want):
        # the NDC warp divides by z: the JAX tests' own 2e-5 / 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=ATOL, err_msg=f"ndc/{name} vs JAX")
        np.testing.assert_allclose(g.numpy(), golden[f"rays_ndc_{name}"],
                                   rtol=2e-5, atol=1e-5,
                                   err_msg=f"ndc/{name} vs golden")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_rays_match_jax(seed):
    K = np.array([[37.0, 0, 10.3], [0, 35.0, 7.9], [0, 0, 1]], np.float32)
    c2w = _pose(seed)
    for as_ndc in (False, True):
        kw = dict(image_h=13, image_w=17, convention="opengl",
                  pixel_center=True, as_ndc=as_ndc, near_plane=1.0)
        got = trays.get_camera_rays_grid(t(K), t(c2w), **kw)
        want = jrays.get_camera_rays_grid(jnp.asarray(K), jnp.asarray(c2w), **kw)
        for name, g, w in zip(FIELDS, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                       atol=ATOL, err_msg=f"{as_ndc}/{name}")


def test_pixel_grid_and_unknown_convention():
    np.testing.assert_array_equal(trays.pixel_grid(2, 3).numpy(),
                                  np.asarray(jrays.pixel_grid(2, 3)))
    np.testing.assert_array_equal(trays.pixel_grid(3, 2, True).numpy(),
                                  np.asarray(jrays.pixel_grid(3, 2, True)))
    with pytest.raises(ValueError):
        trays.get_camera_rays(torch.eye(3), torch.eye(4), torch.zeros(1, 2),
                              image_h=1, image_w=1, convention="nope")


# ---------------- encoding ----------------

def test_encoding_matches_jax_and_golden(golden):
    x = golden["enc_x"]
    pos, dirs = tenc.vanilla_encoders()
    jpos, jdirs = jenc.vanilla_encoders()
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(dirs, jdirs)
    for bands, key in ((pos, "enc_pos10"), (dirs, "enc_dir4")):
        got = tenc.positional_encoding(t(x), bands).numpy()
        want = np.asarray(jenc.positional_encoding(jnp.asarray(x),
                                                   jnp.asarray(bands)))
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, golden[key], rtol=1e-5, atol=1e-6)
    lin = tenc.make_frequency_bands(6, log_spaced=False, use_two_pi=True)
    np.testing.assert_array_equal(
        lin, jenc.make_frequency_bands(6, log_spaced=False, use_two_pi=True))
    got = tenc.positional_encoding(t(x), lin, include_input=False).numpy()
    # sin/cos of 2π-scaled args: the JAX test's own tolerance
    np.testing.assert_allclose(got, golden["enc_lin6_2pi"], rtol=1e-3, atol=5e-5)


def test_encoding_large_arguments_match_jax():
    # marching points up to |x| = 8 reach 2^9 * 8 = 4096 rad in the top band
    x = np.random.RandomState(0).uniform(-8, 8, (64, 3)).astype(np.float32)
    pos, _ = tenc.vanilla_encoders()
    got = tenc.positional_encoding(t(x), pos).numpy()
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), jnp.asarray(pos)))
    # both sides take sin of the same fp32 argument: library ulps only
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encode_dirs_and_dims():
    assert tenc.encoder_out_dim(3, 10) == jenc.encoder_out_dim(3, 10) == 63
    assert tenc.encoder_out_dim(3, 6, False) == 36
    d = np.random.RandomState(1).normal(size=(10, 3)).astype(np.float32)
    _, dirs = tenc.vanilla_encoders()
    np.testing.assert_allclose(
        tenc.encode_dirs(t(d), dirs).numpy(),
        np.asarray(jenc.encode_dirs(jnp.asarray(d), jnp.asarray(dirs))),
        atol=ATOL)
    with pytest.raises(NotImplementedError, match="P7"):
        tenc.encode_dirs(t(d), dirs, dir_encoder="sh")


# ---------------- sampling ----------------

@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_matches_jax(lindisp):
    got = tsamp.stratified_samples(2.0, 6.0, 64, lindisp=lindisp).numpy()
    want = np.asarray(jsamp.stratified_samples(2.0, 6.0, 64, lindisp=lindisp))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_perturb_with_injected_draws_matches_jax():
    z = np.broadcast_to(np.linspace(2, 6, 32, dtype=np.float32), (5, 32))
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, z.shape, dtype=jnp.float32))
    want = np.asarray(jsamp.perturb_z_samples(key, jnp.asarray(z)))
    got = tsamp.perturb_z_samples(t(z), u=t(u)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    g = tsamp.perturb_z_samples(t(z), generator=torch.Generator().manual_seed(0))
    assert bool((g[:, 1:] >= g[:, :-1]).all())
    with pytest.raises(ValueError):
        tsamp.perturb_z_samples(t(z))


def test_sample_pdf_matches_golden(golden):
    for bins, key in (("pdf_mids", "pdf_z_det"), ("pdf_edges", "pdf_z_det_edges")):
        got = tsamp.sample_pdf(t(golden[bins]), t(golden["pdf_weights"]), 128,
                               deterministic=True).numpy()
        np.testing.assert_allclose(got, golden[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [1, 2, 63])
def test_sample_pdf_matches_jax(M):
    rng = np.random.RandomState(M)
    B, S = 9, 40
    mids = np.sort(rng.uniform(2, 6, (B, M)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (B, M)).astype(np.float32)
    w[0] = 0.0                                 # all-zero row: the 1e-5 floor
    w[1, : M // 2] = 0.0                       # flat CDF runs: denom guard
    u = rng.uniform(0, 1, (B, S)).astype(np.float32)
    u[2] = np.linspace(0, 1, S)                # endpoints exactly 0 and 1
    for kw in (dict(u=u), dict(deterministic=True)):
        jkw = {k: (jnp.asarray(v) if k == "u" else v) for k, v in kw.items()}
        tkw = {k: (t(v) if k == "u" else v) for k, v in kw.items()}
        want = np.asarray(jsamp.sample_pdf(jnp.asarray(mids), jnp.asarray(w),
                                           S, **jkw))
        got = tsamp.sample_pdf(t(mids), t(w), S, **tkw).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=str(kw))


def test_sample_pdf_edges_and_stochastic():
    rng = np.random.RandomState(0)
    edges = np.sort(rng.uniform(2, 6, (4, 9)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (4, 8)).astype(np.float32)
    want = np.asarray(jsamp.sample_pdf(jnp.asarray(edges), jnp.asarray(w), 16,
                                       deterministic=True))
    got = tsamp.sample_pdf(t(edges), t(w), 16, deterministic=True).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    z = tsamp.sample_pdf(t(edges), t(w), 64,
                         generator=torch.Generator().manual_seed(1))
    assert z.shape == (4, 64)
    assert bool((z >= t(edges[:, :1])).all() and (z <= t(edges[:, -1:])).all())
    with pytest.raises(ValueError):
        tsamp.sample_pdf(t(edges), t(w), 8)
    with pytest.raises(ValueError):
        tsamp.sample_pdf(t(edges[:, :3]), t(w), 8, deterministic=True)


def test_resample_and_merge_match_jax():
    rng = np.random.RandomState(4)
    z = np.broadcast_to(np.linspace(2, 6, 64, dtype=np.float32), (7, 64))
    w = rng.uniform(0, 0.2, (7, 64)).astype(np.float32)
    want = jsamp.resample_midpoints(jnp.asarray(z), jnp.asarray(w), 128,
                                    deterministic=True)
    got = tsamp.resample_midpoints(t(z), t(w), 128, deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        tsamp.merge_z_samples(t(z), got).numpy(),
        np.asarray(jsamp.merge_z_samples(jnp.asarray(z), want)), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_resample_with_injected_draws_matches_jax(seed):
    """Stochastic fine samples: JAX draws ``uniform(key, (B, n))`` inside
    ``sample_pdf``; the same array given as ``u=`` gives the same z's."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(2, 6, (9, 32)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 0.3, (9, 32)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jsamp.resample_midpoints(jnp.asarray(z), jnp.asarray(w), 48, key=key)
    u = np.asarray(jax.random.uniform(key, (9, 48), dtype=jnp.float32))
    got = tsamp.resample_midpoints(t(z), t(w), 48, u=t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lindisp", [False, True])
def test_distortion_loss_matches_jax(lindisp):
    """mip-NeRF 360's L_dist and its gradient in the weights, 1e-6 relative
    (fp32 prefix sums in another order)."""
    rng = np.random.RandomState(int(lindisp))
    near, far = (0.5, 8.0) if lindisp else (2.0, 6.0)
    z = np.sort(rng.uniform(near, far, (11, 24)), axis=-1).astype(np.float32)
    w = (rng.uniform(0, 1, (11, 24)) ** 4 * 0.3).astype(np.float32)
    want = jsamp.distortion_loss(jnp.asarray(z), jnp.asarray(w), near, far,
                                 lindisp=lindisp)
    gw = jax.grad(lambda w_: jsamp.distortion_loss(jnp.asarray(z), w_, near, far,
                                                   lindisp=lindisp))(jnp.asarray(w))
    tw = t(w).requires_grad_(True)
    got = tsamp.distortion_loss(t(z), tw, near, far, lindisp=lindisp)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-7)
    assert float(got) > 0


# ---------------- integrator ----------------

@pytest.mark.parametrize("ilb", [False, True])
@pytest.mark.parametrize("wb", [False, True])
def test_volume_render_matches_jax_and_golden(golden, ilb, wb):
    args = [golden["vr_rgb"], golden["vr_sigma"], golden["vr_z"]]
    got = tint.volume_render_rays(*map(t, args), ray_norm=t(golden["vr_rn"]),
                                  white_bkgd=wb, infinite_last_bin=ilb)
    want = jint.volume_render_rays(*map(jnp.asarray, args),
                                   ray_norm=jnp.asarray(golden["vr_rn"]),
                                   white_bkgd=wb, infinite_last_bin=ilb)
    tag = f"vr_{int(ilb)}{int(wb)}"
    for g, w, s in zip(got, want, "cwad"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=f"{tag}_{s} vs JAX")
        # the JAX test's tolerances against the reference
        np.testing.assert_allclose(g.numpy(), golden[f"{tag}_{s}"], rtol=1e-4,
                                   atol=1e-5, err_msg=f"{tag}_{s} vs golden")


def test_exclusive_cumprod_matches_jax():
    x = np.random.RandomState(0).uniform(0.5, 1.0, (3, 5, 4)).astype(np.float32)
    for axis in (-1, 1, 0):
        np.testing.assert_allclose(
            tint.exclusive_cumprod(t(x), dim=axis).numpy(),
            np.asarray(jint.exclusive_cumprod(jnp.asarray(x), axis=axis)),
            atol=ATOL)
