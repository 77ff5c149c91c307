"""Stateless NeRF march + composite at fixed z samples (frequency encoder).

Port of ``nerf_sandbox_tpu/models/forward.py:nerf_forward_pass`` (reference
``nerf_sandbox/source/utils/render_utils.py:171-283``) for eval:
``pts = o + d_unit * (z * ||d_raw||)``, unit WORLD view directions per
sample, fp32 encode, the MLP in ``compute_dtype``, sigmoid rgb, relu/softplus
sigma, then ``volume_render_rays``. ``use_kernel=True`` routes the MLP to the
K1 kernel (``ops/fused_mlp.py``) as the JAX ``use_pallas`` does.

The encoders and options of the JAX function that are not ported raise.
"""

from __future__ import annotations

import torch

from nerf_sandbox_tpu_torch.core.encoding import encode_dirs, positional_encoding
from nerf_sandbox_tpu_torch.core.integrator import volume_render_rays
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
from nerf_sandbox_tpu_torch.ops.fused_mlp import fused_nerf_apply


def check_ported_forward(*, pos_encoder: str = "freq", scene_contraction: bool = False,
                         ipe: bool = False, dir_encoder: str = "freq") -> None:
    """Raise for the forward-pass options this package does not port yet."""
    if pos_encoder != "freq":
        item = {"kplanes": "P7 item 2", "hashgrid": "P7 item 8"}.get(
            pos_encoder, "P7")
        raise NotImplementedError(
            f"pos_encoder={pos_encoder!r} is ROADMAP queue 1, {item}")
    if scene_contraction:
        raise NotImplementedError(
            "scene contraction is ROADMAP queue 1, P7 item 1 (kernel K2c)")
    if ipe:
        raise NotImplementedError(
            "IPE is ROADMAP queue 1, P7 item 5 (kernel K4)")
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
    infinite_last_bin: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
    pos_encoder: str = "freq",
    scene_contraction: bool = False,
    ipe: bool = False,
    dir_encoder: str = "freq",
    device=None,
):
    """→ (composite_rgb (B,3), weights (B,N), acc (B,1), depth (B,1)).

    Runs on ``cuda`` unless ``device="cpu"``; the model must be on that
    device. ``use_kernel=True`` runs the MLP through K1 (bf16).
    """
    check_ported_forward(pos_encoder=pos_encoder,
                         scene_contraction=scene_contraction, ipe=ipe,
                         dir_encoder=dir_encoder)
    if raw_noise_std > 0.0:
        raise NotImplementedError(
            "train-time sigma noise comes with the train step, ROADMAP "
            "queue 1, P4")
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

    if viewdirs_world_unit is not None:
        vd = viewdirs_world_unit.to(dev, torch.float32)
        vn = torch.linalg.vector_norm(vd, dim=-1, keepdim=True)
        vdirs = vd / torch.clamp(vn, min=1e-12)
    else:
        vdirs = rays_d_unit
    vdirs = vdirs[:, None, :].expand(pts.shape)

    # Encode in fp32 (sin/cos of large 2^k x need the fp32 mantissa), then
    # run the MLP in compute_dtype.
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
    if sigma_activation == "softplus":
        sigma = torch.nn.functional.softplus(sigma)
    else:
        sigma = torch.relu(sigma)

    return volume_render_rays(
        rgb.reshape(B, N, 3).float(), sigma.reshape(B, N).float(), z_vals,
        ray_norm=ray_norms, white_bkgd=white_bkgd,
        infinite_last_bin=infinite_last_bin)
