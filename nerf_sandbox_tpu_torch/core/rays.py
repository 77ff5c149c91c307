"""Camera-ray generation (world + marching/NDC spaces).

Port of ``nerf_sandbox_tpu/core/rays.py`` (reference
``nerf_sandbox/source/utils/ray_utils.py:11-136``): pinhole unprojection with
the same conventions, the 1e-9 unit-normalisation epsilon on world
directions, and the exact nerf-pytorch NDC warp. Functions of tensors, batched
over leading ray dimensions; everything runs in fp32 on the inputs' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Camera conventions → (sign of y_cam, sign of z component of the camera-space dir).
# reference: ray_utils.py:69-77
_CONVENTIONS = {
    "opengl": (-1.0, -1.0),
    "blender": (-1.0, -1.0),
    "nerf": (-1.0, -1.0),
    "opencv": (1.0, 1.0),
    "colmap": (1.0, 1.0),
    "pytorch3d": (-1.0, 1.0),
    "p3d": (-1.0, 1.0),
}


class RayBundle(NamedTuple):
    """The 6-tuple ray contract of the reference (ray_utils.py:129-136)."""

    o_world: torch.Tensor        # (..., 3)
    d_world_unit: torch.Tensor   # (..., 3)
    d_world_norm: torch.Tensor   # (..., 1)  ||d_raw|| before normalisation
    o_march: torch.Tensor        # (..., 3)  world or NDC
    d_march_unit: torch.Tensor   # (..., 3)
    d_march_norm: torch.Tensor   # (..., 1)


def pixel_grid(image_h: int, image_w: int, pixel_center: bool = False,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Full-image pixel coordinates in row-major (y-first) order, (H*W, 2) [x, y]."""
    ys = torch.arange(image_h, dtype=dtype, device=device)
    xs = torch.arange(image_w, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    px = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    if pixel_center:
        px = px + 0.5
    return px


def ndc_warp(rays_o: torch.Tensor, rays_d_raw: torch.Tensor, *, image_h: int,
             image_w: int, focal, near_plane: float):
    """The nerf-pytorch NDC warp (ray_utils.py:92-126) → (o_ndc, d_ndc_raw).

    ``rays_d_raw`` must be the UN-normalised world directions.
    """
    sx = 2.0 * focal / float(image_w)
    sy = 2.0 * focal / float(image_h)

    oz = rays_o[..., 2]
    dz = rays_d_raw[..., 2]
    t_ndc = -(near_plane + oz) / (dz + 1e-9)
    o_w = rays_o + t_ndc[..., None] * rays_d_raw

    o0 = -sx * (o_w[..., 0] / (o_w[..., 2] + 1e-9))
    o1 = -sy * (o_w[..., 1] / (o_w[..., 2] + 1e-9))
    o2 = 1.0 + 2.0 * near_plane / (o_w[..., 2] + 1e-9)

    d0 = -sx * ((rays_d_raw[..., 0] / (rays_d_raw[..., 2] + 1e-9))
                - (o_w[..., 0] / (o_w[..., 2] + 1e-9)))
    d1 = -sy * ((rays_d_raw[..., 1] / (rays_d_raw[..., 2] + 1e-9))
                - (o_w[..., 1] / (o_w[..., 2] + 1e-9)))
    d2 = -2.0 * near_plane / (o_w[..., 2] + 1e-9)

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def get_camera_rays(
    K: torch.Tensor,                # (3, 3), or (..., 3, 3) one per pixel
    c2w: torch.Tensor,              # (3, 4) or (4, 4), or (..., 3, 4) one per pixel
    pixels_xy: torch.Tensor,        # (..., 2) [x, y] pixel coordinates
    *,
    image_h: int,
    image_w: int,
    convention: str = "opengl",
    pixel_center: bool = False,
    as_ndc: bool = False,
    near_plane: float = 1.0,
) -> RayBundle:
    """World + marching rays for the given pixels (ray_utils.py:11-136).
    A camera per pixel (``K`` (..., 3, 3), ``c2w`` (..., 3, 4)) is the JAX
    sampler's vmap over per-ray cameras."""
    K = K.to(torch.float32)
    c2w = c2w.to(torch.float32)
    px = pixels_xy.to(torch.float32)
    if pixel_center:
        px = px + 0.5
    x_cam = (px[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    y_cam = (px[..., 1] - K[..., 1, 2]) / K[..., 1, 1]

    conv = (convention or "opengl").lower()
    if conv not in _CONVENTIONS:
        raise ValueError(f"Unknown convention '{convention}'")
    sy_sign, sz_sign = _CONVENTIONS[conv]
    dirs_cam = torch.stack(
        [x_cam, sy_sign * y_cam, sz_sign * torch.ones_like(x_cam)], dim=-1)

    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    # The JAX package pins this contraction to HIGHEST; here it is a true
    # fp32 product (TF32 is off, device.py).
    if R.dim() == 2:
        d_world_raw = dirs_cam @ R.T
    else:
        d_world_raw = (dirs_cam[..., None, :] @ R.transpose(-1, -2))[..., 0, :]

    d_world_norm = torch.linalg.vector_norm(d_world_raw, dim=-1, keepdim=True)
    d_world_unit = d_world_raw / (d_world_norm + 1e-9)
    o_world = t.expand(d_world_raw.shape)

    if not as_ndc:
        return RayBundle(o_world, d_world_unit, d_world_norm,
                         o_world, d_world_unit, d_world_norm)

    o_ndc, d_ndc_raw = ndc_warp(
        o_world, d_world_raw, image_h=image_h, image_w=image_w,
        focal=K[..., 0, 0], near_plane=float(near_plane))
    d_march_norm = torch.linalg.vector_norm(d_ndc_raw, dim=-1, keepdim=True)
    # torch.nn.functional.normalize semantics, eps=1e-12 (ray_utils.py:126)
    d_march_unit = d_ndc_raw / torch.clamp(d_march_norm, min=1e-12)
    return RayBundle(o_world, d_world_unit, d_world_norm,
                     o_ndc, d_march_unit, d_march_norm)


def get_camera_rays_grid(K: torch.Tensor, c2w: torch.Tensor, *, image_h: int,
                         image_w: int, **kwargs) -> RayBundle:
    """Full-image convenience wrapper: rays for every pixel, shape (H*W, ...)."""
    px = pixel_grid(image_h, image_w, pixel_center=False, device=K.device)
    return get_camera_rays(K, c2w, px, image_h=image_h, image_w=image_w, **kwargs)
