"""The port's scene records and ray-batch sampler (``nerf_sandbox_tpu_torch/
data/``) against ``nerf_sandbox_tpu.data.sampler`` on the CPU, with the pixel
draws JAX makes on its own keys handed to the port.

Tolerances: the uint8 targets bit-equal (gather, /255, RGBA over white in
JAX's order); frame ids and times exact; camera rays and radii 1e-6
relative to their scale (fp32 unprojection, one 3x3 product per ray, the NDC
warp's divisions); NDC rays 1e-5 (the warp divides by the near-plane depth).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.data import sampler as jsampler
from nerf_sandbox_tpu.data.scene import Frame as JFrame, Scene as JScene
from nerf_sandbox_tpu_torch.data import sampler as tsampler
from nerf_sandbox_tpu_torch.data.scene import Frame, Scene

RAY_KEYS = ("rays_o_world", "rays_d_world_unit", "rays_d_world_norm",
            "rays_o_marching", "rays_d_marching_unit", "rays_d_marching_norm",
            "radii")


def _frames(n=3, H=12, W=16, channels=4, uint8=True, times=False, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        K = np.array([[14.0 + i, 0, W / 2 + 0.3 * i], [0, 14.5 + i, H / 2], [0, 0, 1]],
                     np.float32)
        th = 0.4 * i + 0.1
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0.1 * i, -0.2, 4.0], np.float32)
        img = (rng.randint(0, 256, (H, W, channels)).astype(np.uint8) if uint8
               else rng.uniform(0, 1, (H, W, channels)).astype(np.float32))
        out.append(dict(image=img, K=K, c2w=c2w,
                        time=(i / max(n - 1, 1)) if times else None))
    return out


def _scenes(**kw):
    frames = _frames(**kw)
    jscene = JScene(frames=[JFrame(**f) for f in frames])
    tscene = Scene(frames=[Frame(**f) for f in frames])
    return (jsampler.SceneArrays.from_scene(jscene),
            tsampler.SceneArrays.from_scene(tscene, device="cpu"))


def _pair(jarr, tarr, step, seed=0, **spec_kw):
    H, W = tarr.hw
    kw = dict(rays_per_batch=64, image_h=H, image_w=W)
    kw.update(spec_kw)
    jspec, tspec = jsampler.RayBatchSpec(**kw), tsampler.RayBatchSpec(**kw)
    key = jax.random.PRNGKey(seed)
    pix = jsampler.sample_pixels(key, jnp.int32(step), jarr, jspec)
    want = jsampler.sample_ray_batch(key, jnp.int32(step), jarr, jspec)
    got = tsampler.sample_ray_batch(
        step, tarr, tspec, fids=np.asarray(pix["frame_ids"]),
        ys=np.asarray(pix["ys"]), xs=np.asarray(pix["xs"]), device="cpu")
    return pix, {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def _hold(want, got, rtol=1e-6):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    np.testing.assert_array_equal(got["frame_ids"], want["frame_ids"])
    np.testing.assert_array_equal(got["t"], want["t"])
    for k in RAY_KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rtol * scale,
                                   err_msg=k)


def test_scene_arrays_match_jax():
    jarr, tarr = _scenes(times=True, uint8=False)
    np.testing.assert_array_equal(tarr.images.numpy(), np.asarray(jarr.images))
    np.testing.assert_array_equal(tarr.Ks.numpy(), np.asarray(jarr.Ks))
    np.testing.assert_array_equal(tarr.c2ws.numpy(), np.asarray(jarr.c2ws))
    np.testing.assert_array_equal(tarr.times.numpy(), np.asarray(jarr.times))
    assert tarr.images.dtype == torch.uint8 and tarr.n_frames == 3
    assert tarr.hw == (12, 16)


@pytest.mark.parametrize("channels,white", [(4, True), (4, False), (3, True)])
def test_batch_matches_jax_and_targets_are_bit_equal(channels, white):
    """RGBA over white, RGBA without it, and RGB."""
    jarr, tarr = _scenes(channels=channels)
    _, want, got = _pair(jarr, tarr, 5, seed=channels, white_bkgd=white)
    _hold(want, got)
    assert got["rgb"].shape == (64, 3)


@pytest.mark.parametrize("step", [1, 10, 11, 50])
def test_precrop_gate_matches_jax(step):
    """The 1-based ``step <= precrop_iters`` gate: steps 1 and 10 crop, 11 and
    50 do not; the port's bounds equal JAX's and the batch matches."""
    jarr, tarr = _scenes(H=20, W=24)
    spec_kw = dict(precrop_iters=10, precrop_frac=0.5)
    pix, want, got = _pair(jarr, tarr, step, seed=step, **spec_kw)
    _hold(want, got)
    spec = jsampler.RayBatchSpec(64, 20, 24, **spec_kw)
    jb = [int(b) for b in jsampler._crop_bounds(jnp.int32(step), spec)]
    tb = [int(b) for b in tsampler.crop_bounds(step, tsampler.RayBatchSpec(
        64, 20, 24, **spec_kw))]
    assert tb == jb
    assert (jb == [5, 15, 6, 18]) == (step <= 10)
    ys, xs = np.asarray(pix["ys"]), np.asarray(pix["xs"])
    assert ys.min() >= jb[0] and ys.max() < jb[1] and xs.min() >= jb[2] and xs.max() < jb[3]


def test_single_frame_matches_jax():
    jarr, tarr = _scenes(n=4)
    pix, want, got = _pair(jarr, tarr, 3, seed=7, single_frame=True)
    _hold(want, got)
    assert len(set(np.asarray(pix["frame_ids"]).tolist())) == 1


@pytest.mark.parametrize("convention", ["opengl", "opencv"])
def test_ndc_batch_matches_jax(convention):
    jarr, tarr = _scenes()
    _, want, got = _pair(jarr, tarr, 2, seed=3, as_ndc=True, near_plane=1.0,
                         convention=convention)
    _hold(want, got, rtol=1e-5)
    assert not np.allclose(got["rays_o_marching"], got["rays_o_world"])


def test_times_and_radii_follow_the_frames():
    jarr, tarr = _scenes(times=True)
    _, want, got = _pair(jarr, tarr, 4, seed=9)
    _hold(want, got)
    fx = tarr.Ks[:, 0, 0].numpy()[got["frame_ids"]]
    np.testing.assert_allclose(got["radii"] * got["rays_d_world_norm"][:, 0],
                               2 / np.sqrt(12) / fx, rtol=1e-5)
    np.testing.assert_array_equal(got["t"], tarr.times.numpy()[got["frame_ids"]])


@pytest.mark.parametrize("single_frame", [False, True])
def test_own_draws_stay_in_bounds(single_frame):
    """Without injected draws the sampler draws from its generator: frames in
    range (one frame under single_frame), pixels inside the precrop window
    while it is open and across the image after."""
    _, tarr = _scenes(n=4, H=20, W=24)
    spec = tsampler.RayBatchSpec(512, 20, 24, precrop_iters=3, precrop_frac=0.5,
                                 single_frame=single_frame)
    g = torch.Generator().manual_seed(0)
    for step, (h0, h1, w0, w1) in ((3, (5, 15, 6, 18)), (4, (0, 20, 0, 24))):
        d = tsampler.draw_pixels(torch.tensor(step), tarr, spec, g)
        assert d["ys"].min() >= h0 and d["ys"].max() < h1
        assert d["xs"].min() >= w0 and d["xs"].max() < w1
        assert d["fids"].min() >= 0 and d["fids"].max() < 4
        assert (len(set(d["fids"].tolist())) == 1) == single_frame
    batch = tsampler.sample_ray_batch(4, tarr, spec, generator=g, device="cpu")
    assert batch["rgb"].shape == (512, 3) and torch.isfinite(batch["radii"]).all()


def test_unported_options_raise():
    _, tarr = _scenes()
    spec = tsampler.RayBatchSpec(8, 12, 16, shard_frames=True)
    with pytest.raises(NotImplementedError, match="P9"):
        tsampler.sample_ray_batch(1, tarr, spec, generator=torch.Generator(),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="P7 item 9"):
        tsampler.rays_for_pixels(tarr, tsampler.RayBatchSpec(8, 12, 16),
                                 torch.zeros(8, dtype=torch.long),
                                 torch.zeros(8, dtype=torch.long),
                                 torch.zeros(8, dtype=torch.long),
                                 pose_delta=torch.zeros(8, 6))
