"""The training ray sampler: per-step random pixel batches from a scene kept
on the card.

Port of ``nerf_sandbox_tpu/data/sampler.py`` (reference
``nerf_sandbox/source/data/samplers.py:22-291``): frame ids and pixel
indices drawn per step in two modes (single-frame à la bmild, or mixed
frames), a centre precrop for the first ``precrop_iters`` steps, RGBA→white
compositing, and the 7-key batch {rgb, rays_o_world, rays_d_world_unit,
rays_d_world_norm, rays_o_marching, rays_d_marching_unit,
rays_d_marching_norm} plus ``radii`` (IPE pixel-cone radii), ``t`` (frame
times) and ``frame_ids``.

The scene is stacked once into tensors on the card (images as uint8, 4x
less memory than fp32), and a batch is one gather ``images[fids, ys, xs]``
and one batched ray generation with a camera per ray. The JAX package looks
the cameras up with a one-hot matmul because row gathers are slow on a TPU;
here they are gathers. The precrop bounds stay tensors, so a step never
waits on the host. Draws are injectable (``fids``, ``ys``, ``xs``), as every
drawing function of this package; otherwise they come from an explicit
``torch.Generator`` on the scene's device.

Not ported: the frame-sharded image bank (``from_scene_sharded`` and its
gather, ``RayBatchSpec.shard_frames``; ROADMAP P9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_sandbox_tpu_torch.core.encoding import pixel_cone_radii
from nerf_sandbox_tpu_torch.core.rays import get_camera_rays
from nerf_sandbox_tpu_torch.data.scene import Scene
from nerf_sandbox_tpu_torch.device import resolve_device


class SceneArrays(NamedTuple):
    """The whole scene stacked into tensors on one device."""

    images: torch.Tensor   # (N, H, W, C) uint8
    Ks: torch.Tensor       # (N, 3, 3) float32
    c2ws: torch.Tensor     # (N, 3, 4) float32
    times: torch.Tensor    # (N,) float32, normalised frame times (0: static)

    @property
    def n_frames(self) -> int:
        return self.Ks.shape[0]

    @property
    def hw(self):
        return self.images.shape[1], self.images.shape[2]

    @property
    def device(self) -> torch.device:
        return self.images.device

    @staticmethod
    def _frame_uint8(f) -> np.ndarray:
        img = np.asarray(f.image)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return img

    @staticmethod
    def from_scene(scene: Scene, device=None) -> "SceneArrays":
        """Stack the frames onto ``device`` (``cuda`` unless ``"cpu"``)."""
        dev = resolve_device(device)
        images = np.stack([SceneArrays._frame_uint8(f) for f in scene.frames])
        Ks = np.stack([np.asarray(f.K, np.float32) for f in scene.frames])
        c2ws = np.stack([f.c2w_3x4() for f in scene.frames])
        times = np.asarray([f.time if f.time is not None else 0.0
                            for f in scene.frames], np.float32)
        return SceneArrays(*(torch.from_numpy(a).to(dev)
                             for a in (images, Ks, c2ws, times)))


class RayBatchSpec(NamedTuple):
    """Static sampler configuration."""

    rays_per_batch: int
    image_h: int
    image_w: int
    convention: str = "opengl"
    as_ndc: bool = False
    near_plane: float = 1.0
    white_bkgd: bool = True
    single_frame: bool = False
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    # the frame-sharded image bank of the JAX package: not ported
    shard_frames: bool = False


def check_spec(spec: RayBatchSpec) -> None:
    if spec.shard_frames:
        raise NotImplementedError(
            "a frame-sharded image bank (shard_frames) is ROADMAP queue 1, P9")


def crop_bounds(step, spec: RayBatchSpec, device=None):
    """Centre-crop pixel bounds (h0, h1, w0, w1) for the first
    ``precrop_iters`` steps (samplers.py:119-127), as int64 tensors on
    ``step``'s device. ``step`` is the 1-based step in progress; the
    reference gates on a 0-based completed count (< precrop_iters), so
    ``step <= precrop_iters`` gives the same precrop_iters cropped batches."""
    H, W = spec.image_h, spec.image_w
    step = torch.as_tensor(step, device=device)
    full = [0, H, 0, W]
    if spec.precrop_iters <= 0 or not (0.0 < spec.precrop_frac < 1.0):
        return tuple(torch.tensor(v, device=step.device) for v in full)
    f = spec.precrop_frac
    crop = [int(H * 0.5 * (1.0 - f)), int(H * 0.5 * (1.0 + f)),
            int(W * 0.5 * (1.0 - f)), int(W * 0.5 * (1.0 + f))]
    active = step <= spec.precrop_iters
    return tuple(torch.where(active, torch.tensor(c, device=step.device),
                             torch.tensor(v, device=step.device))
                 for c, v in zip(crop, full))


def draw_pixels(step, scene: SceneArrays, spec: RayBatchSpec,
                generator: torch.Generator) -> dict:
    """Frame ids and pixel indices of one batch from ``generator`` (on the
    scene's device): ``{"fids", "ys", "xs"}``, int64 (B,). Frames uniform
    (one frame for the whole batch under ``single_frame``), pixels uniform in
    the precrop bounds, drawn as ``lo + floor(u (hi - lo))`` so that the
    bounds stay on the device."""
    B, dev = spec.rays_per_batch, scene.device
    if spec.single_frame:
        fid = torch.randint(0, scene.n_frames, (1,), generator=generator, device=dev)
        fids = fid.expand(B).clone()
    else:
        fids = torch.randint(0, scene.n_frames, (B,), generator=generator, device=dev)
    h0, h1, w0, w1 = crop_bounds(step, spec, device=dev)

    def uniform_int(lo, hi):
        u = torch.rand((B,), generator=generator, device=dev, dtype=torch.float64)
        return torch.minimum(lo + (u * (hi - lo)).long(), hi - 1)

    return {"fids": fids, "ys": uniform_int(h0, h1), "xs": uniform_int(w0, w1)}


def sample_pixels(scene: SceneArrays, spec: RayBatchSpec, fids, ys, xs) -> dict:
    """Target colours of the drawn pixels → {rgb (B, 3), frame_ids, xs, ys}:
    the uint8 gather, then /255, then RGBA over white (JAX
    sampler.py:238-246, in that order). Bit-equal to the JAX package as XLA
    compiles it: /255 as a product with the fp32 reciprocal, and the
    compositing ``rgb·a + (1 - a)`` as one fused multiply-add (one rounding;
    the fp64 product of two fp32 values is exact), which this reproduces for
    every pair of uint8 values."""
    check_spec(spec)
    dev = scene.device
    fids, ys, xs = (torch.as_tensor(np.array(a) if isinstance(a, np.ndarray) else a,
                                    device=dev).long() for a in (fids, ys, xs))
    pix = scene.images[fids, ys, xs].to(torch.float32) * (1.0 / 255.0)   # (B, C)
    if pix.shape[-1] == 4:
        if spec.white_bkgd:
            a = pix[..., 3:4]
            rgb = (pix[..., :3].double() * a.double() + (1.0 - a).double()).float()
        else:
            rgb = pix[..., :3]
    else:
        rgb = pix
    return {"rgb": rgb, "frame_ids": fids, "xs": xs, "ys": ys}


def rays_for_pixels(scene: SceneArrays, spec: RayBatchSpec, fids, xs, ys,
                    pose_delta=None) -> dict:
    """Per-ray camera lookup and ray generation (JAX sampler.py:250-302):
    the 6 ray keys, ``radii`` (pixel-cone radii from each ray's fx) and
    ``t`` (each ray's frame time)."""
    if pose_delta is not None:
        raise NotImplementedError(
            "camera refinement (pose_delta) is ROADMAP queue 1, P7 item 9")
    Ks, c2ws, t = scene.Ks[fids], scene.c2ws[fids], scene.times[fids]
    pixels_xy = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], -1)
    rays = get_camera_rays(Ks, c2ws, pixels_xy, image_h=spec.image_h,
                           image_w=spec.image_w, convention=spec.convention,
                           pixel_center=True, as_ndc=spec.as_ndc,
                           near_plane=spec.near_plane)
    radii = pixel_cone_radii(Ks[:, 0, 0], rays.d_world_norm[..., 0])
    return {
        "rays_o_world": rays.o_world,
        "rays_d_world_unit": rays.d_world_unit,
        "rays_d_world_norm": rays.d_world_norm,
        "rays_o_marching": rays.o_march,
        "rays_d_marching_unit": rays.d_march_unit,
        "rays_d_marching_norm": rays.d_march_norm,
        "radii": radii,
        "t": t,
    }


def sample_ray_batch(step, scene: SceneArrays, spec: RayBatchSpec, *,
                     generator: torch.Generator | None = None, fids=None,
                     ys=None, xs=None, device=None) -> dict:
    """One training batch of rays → the 7-key batch, ``radii``, ``t`` and
    ``frame_ids``. ``step`` is the 1-based step in progress (it gates the
    precrop). The draws ``fids``, ``ys``, ``xs`` (each (B,)) are injected, or
    all drawn from ``generator``. Runs on ``cuda`` unless ``device="cpu"``;
    the scene must be on that device."""
    dev = resolve_device(device)
    check_spec(spec)
    if scene.device.type != dev.type:
        raise ValueError(f"scene is on {scene.device}, asked to run on {dev}")
    if fids is None or ys is None or xs is None:
        if generator is None:
            raise ValueError("sample_ray_batch: pass a generator or the draws "
                             "fids, ys and xs")
        d = draw_pixels(step, scene, spec, generator)
        fids, ys, xs = d["fids"], d["ys"], d["xs"]
    pix = sample_pixels(scene, spec, fids, ys, xs)
    rays = rays_for_pixels(scene, spec, pix["frame_ids"], pix["xs"], pix["ys"])
    return {"rgb": pix["rgb"], **rays, "frame_ids": pix["frame_ids"]}
