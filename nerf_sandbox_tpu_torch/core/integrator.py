"""Volume rendering (alpha compositing) over per-ray samples.

Port of ``nerf_sandbox_tpu/core/integrator.py`` (reference
``nerf_sandbox/source/utils/render_utils.py:108-167``): deltas with a 1e10
or 0 last bin, scaled by ``||d_raw||``; alpha = 1 - exp(-clamp(σΔ, 0, 60));
exclusive cumprod of (1 - alpha + 1e-10); nan-guarded weights; clamped acc;
depth = Σwz / (acc + eps); composite (+ white background) clamped to [0, 1].
All fp32.
"""

from __future__ import annotations

import torch


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod shifted right with a leading 1 (render_utils.py:147-150)."""
    moved = x.movedim(dim, -1)
    shifted = torch.cat([torch.ones_like(moved[..., :1]), moved], dim=-1)
    out = torch.cumprod(shifted, dim=-1)[..., :-1]
    return out.movedim(-1, dim)


def volume_render_rays(
    rgb: torch.Tensor,                  # (B, N, 3) — post-sigmoid
    sigma: torch.Tensor,                # (B, N)    — post-activation
    z_depths: torch.Tensor,             # (B, N)    — sorted
    ray_norm: torch.Tensor | None = None,   # (B,) or (B,1): ||d_raw||
    *,
    white_bkgd: bool = False,
    eps: float = 1e-10,
    infinite_last_bin: bool = False,
):
    """→ (composite_rgb (B,3), weights (B,N), acc (B,1), depth (B,1))."""
    deltas_finite = z_depths[..., 1:] - z_depths[..., :-1]
    delta_last = torch.full_like(deltas_finite[..., :1],
                                 1e10 if infinite_last_bin else 0.0)
    deltas = torch.cat([deltas_finite, delta_last], dim=-1)          # (B, N)
    if ray_norm is not None:
        deltas = deltas * ray_norm.reshape(ray_norm.shape[0], 1).to(deltas.dtype)

    alphas = 1.0 - torch.exp(-torch.clamp(sigma * deltas, 0.0, 60.0))
    transmittance = exclusive_cumprod(1.0 - alphas + eps, dim=-1)
    weights = torch.nan_to_num(transmittance * alphas, nan=0.0, posinf=0.0,
                               neginf=0.0)

    acc = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), 0.0, 1.0)
    depth = torch.sum(weights * z_depths, dim=-1, keepdim=True) / (acc + eps)

    composite = torch.sum(weights[..., None] * rgb, dim=-2)
    if white_bkgd:
        composite = composite + (1.0 - acc)
    composite = torch.clamp(
        torch.nan_to_num(composite, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)
    return composite, weights, acc, depth
