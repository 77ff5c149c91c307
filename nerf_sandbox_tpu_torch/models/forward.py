"""Stateless NeRF march + composite at fixed z samples.

Port of ``nerf_sandbox_tpu/models/forward.py:nerf_forward_pass`` (reference
``nerf_sandbox/source/utils/render_utils.py:171-283``) for eval:
``pts = o + d_unit * (z * ||d_raw||)``, optionally contracted (mip-NeRF 360;
only the encoder sees the warped points, z stays metric), unit WORLD view
directions per sample, the frequency encode in fp32, its integrated form
(mip-NeRF IPE: each sample a conical-frustum Gaussian over its interval,
pushed through the contraction's Jacobian when contracting), or the
k-planes encode (the model's ``pos_grid``, in ``compute_dtype``, per-ray
times for 4-D grids), the MLP in ``compute_dtype``, sigmoid rgb,
relu/softplus sigma, then ``volume_render_rays``. ``use_kernel=True`` routes
the MLP to the K1 kernel (``ops/fused_mlp.py``) as the JAX ``use_pallas``
does, and the k-planes encode to K3's encode-only kernel
(``ops/kplanes_encode.py``, bf16 rows) when all rays share one time.

The encoders and options of the JAX function that are not ported raise.
"""

from __future__ import annotations

import torch

from nerf_sandbox_tpu_torch.core.encoding import (
    conical_frustum_moments, contract_gaussian, encode_dirs,
    integrated_positional_encoding, lift_gaussian_diag, positional_encoding,
    scene_contract, z_to_intervals)
from nerf_sandbox_tpu_torch.core.integrator import volume_render_rays
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.kplanes import kplanes_encode
from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
from nerf_sandbox_tpu_torch.ops.fused_mlp import _enc_pads, fused_nerf_apply
from nerf_sandbox_tpu_torch.ops.kplanes_encode import (
    fused_kplanes_encode, pack_kplanes)


def check_ported_forward(*, pos_encoder: str = "freq", ipe: bool = False,
                         dir_encoder: str = "freq") -> None:
    """Raise for the forward-pass options this package does not port yet,
    and for IPE with another encoder than ``freq``."""
    if pos_encoder not in ("freq", "kplanes"):
        item = {"hashgrid": "P7 item 8"}.get(pos_encoder, "P7")
        raise NotImplementedError(
            f"pos_encoder={pos_encoder!r} is ROADMAP queue 1, {item}")
    if ipe and pos_encoder != "freq":
        raise ValueError(f"IPE applies to the freq encoder only, not "
                         f"pos_encoder={pos_encoder!r}")
    if dir_encoder != "freq":
        raise NotImplementedError(
            "spherical-harmonics dirs are ROADMAP queue 1, P7 item 6")


def nerf_forward_pass(
    model: NeRFMLP,
    rays_o: torch.Tensor,            # (B, 3) marching-space origins
    rays_d_unit: torch.Tensor,       # (B, 3) unit marching dirs
    z_vals: torch.Tensor,            # (B, N) sorted
    *,
    pos_bands,                       # (Fp,)
    dir_bands,                       # (Fd,)
    pos_include_input: bool = True,
    dir_include_input: bool = True,
    white_bkgd: bool,
    ray_norms: torch.Tensor | None = None,          # (B,) or (B,1)
    viewdirs_world_unit: torch.Tensor | None = None,  # (B, 3)
    sigma_activation: str = "relu",
    raw_noise_std: float = 0.0,
    noise: torch.Tensor | None = None,    # (B, N) or (B·N,) N(0, 1) draws
    infinite_last_bin: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
    pos_encoder: str = "freq",
    enc_cfg=None,                    # KPlanesConfig for pos_encoder="kplanes"
    scene_contraction: bool = False,
    ipe: bool = False,               # mip-NeRF integrated positional encoding
    radii: torch.Tensor | None = None,   # (B,) or (B,1) pixel-cone radii (IPE)
    dir_encoder: str = "freq",
    t: torch.Tensor | None = None,   # (B,) normalised times (4-D k-planes)
    device=None,
):
    """→ (composite_rgb (B,3), weights (B,N), acc (B,1), depth (B,1)).

    Runs on ``cuda`` unless ``device="cpu"``; the model must be on that
    device. ``use_kernel=True`` runs the MLP through K1 (bf16) and a k-planes
    encode through K3, which folds a 4-D grid at one time; rays of a 4-D grid
    at different times are encoded per sample in plain PyTorch, as JAX does.
    ``ipe=True`` needs the frequency encoder and per-ray ``radii``.
    ``raw_noise_std`` > 0 with standard-normal ``noise`` adds
    ``noise · raw_noise_std`` to the pre-activation sigma, in fp32 then cast
    to sigma's type (JAX models/forward.py:161-163); without ``noise``, as
    JAX without a noise key, none is added.
    """
    check_ported_forward(pos_encoder=pos_encoder, ipe=ipe,
                         dir_encoder=dir_encoder)
    dev = resolve_device(device)
    rays_o, rays_d_unit, z_vals = (t.to(dev, torch.float32)
                                   for t in (rays_o, rays_d_unit, z_vals))
    B, N = z_vals.shape

    if ray_norms is None:
        z_metric = z_vals
    else:
        ray_norms = ray_norms.to(dev, torch.float32)
        z_metric = z_vals * ray_norms.reshape(B, 1)
    pts = rays_o[:, None, :] + rays_d_unit[:, None, :] * z_metric[..., None]
    ipe_gaussian = None
    if ipe:
        # each sample becomes the Gaussian of its conical frustum; under
        # contraction the Gaussian is pushed through the warp instead of the
        # points (JAX models/forward.py:72-93)
        if radii is None:
            raise ValueError("IPE needs per-ray pixel-cone radii")
        lower, upper = z_to_intervals(z_metric)
        t_mean, t_var, r_var = conical_frustum_moments(
            lower, upper, radii.to(dev, torch.float32).reshape(B, 1))
        mean, var = lift_gaussian_diag(rays_d_unit, t_mean, t_var, r_var,
                                       rays_o)
        if scene_contraction:
            mean, var = contract_gaussian(mean, rays_d_unit, t_var, r_var)
        ipe_gaussian = (mean, var)
    elif scene_contraction:
        pts = scene_contract(pts)

    if viewdirs_world_unit is not None:
        vd = viewdirs_world_unit.to(dev, torch.float32)
        vn = torch.linalg.vector_norm(vd, dim=-1, keepdim=True)
        vdirs = vd / torch.clamp(vn, min=1e-12)
    else:
        vdirs = rays_d_unit
    vdirs = vdirs[:, None, :].expand(pts.shape)

    # Encode in fp32 (sin/cos of large 2^k x need the fp32 mantissa), then
    # run the MLP in compute_dtype.
    if ipe_gaussian is not None:
        mean, var = ipe_gaussian
        enc_pos = integrated_positional_encoding(
            mean.reshape(-1, 3), var.reshape(-1, 3), pos_bands,
            include_input=pos_include_input)
    elif pos_encoder == "kplanes":
        enc_pos = _kplanes_rows(model, pts.reshape(-1, 3), enc_cfg, t, B, N,
                                compute_dtype, use_kernel, dev)
    else:
        enc_pos = positional_encoding(pts.reshape(-1, 3), pos_bands,
                                      include_input=pos_include_input)
    enc_dir = encode_dirs(vdirs.reshape(-1, 3), dir_bands,
                          include_input=dir_include_input,
                          dir_encoder=dir_encoder)
    if use_kernel:
        out = fused_nerf_apply(model, enc_pos, enc_dir, device=dev)
    else:
        mlp_dtype = None if compute_dtype == torch.float32 else compute_dtype
        out = model(enc_pos, enc_dir, compute_dtype=mlp_dtype)
    rgb = torch.sigmoid(out[..., :3])
    sigma = out[..., 3]
    if raw_noise_std > 0.0 and noise is not None:
        noise = noise.to(dev, torch.float32).reshape(sigma.shape)
        sigma = sigma + (noise * raw_noise_std).to(sigma.dtype)
    if sigma_activation == "softplus":
        sigma = torch.nn.functional.softplus(sigma)
    else:
        sigma = torch.relu(sigma)

    return volume_render_rays(
        rgb.reshape(B, N, 3).float(), sigma.reshape(B, N).float(), z_vals,
        ray_norm=ray_norms, white_bkgd=white_bkgd,
        infinite_last_bin=infinite_last_bin)


def _kplanes_rows(model: NeRFMLP, pts: torch.Tensor, enc_cfg, t, B: int,
                  N: int, compute_dtype, use_kernel: bool, dev) -> torch.Tensor:
    """The k-planes encode of (B·N, 3) points for ``nerf_forward_pass``."""
    grid = model.pos_grid
    if grid is None or enc_cfg is None:
        raise ValueError("pos_encoder='kplanes' needs enc_cfg and a model "
                         "built with grid_cfg (its pos_grid)")
    t_ray = None
    if enc_cfg.time_res > 0:
        if t is None:
            raise ValueError("4-D k-planes (time_res > 0) needs per-ray times t")
        t_ray = t.to(dev, torch.float32).reshape(B)
    # Rays at one time fold the grid once and take K3's encode-only entry.
    # Per-ray times are encoded per sample, as JAX's use_pallas path does
    # through XLA (it runs no kernel for this encode); the MLP stays on K1.
    one_time = t_ray is None or bool(torch.all(t_ray == t_ray.reshape(-1)[:1]))
    if use_kernel and one_time:
        ep_pad, _ = _enc_pads(model.cfg)
        rows = fused_kplanes_encode(pack_kplanes(grid, enc_cfg, t=t_ray), pts,
                                    ep_pad, device=dev)
        return rows[:, :enc_cfg.out_dim]
    t01 = None if t_ray is None else t_ray[:, None].expand(B, N).reshape(-1)
    return kplanes_encode(grid, pts, enc_cfg, compute_dtype=compute_dtype,
                          t01=t01)
