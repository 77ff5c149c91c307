"""Full-image (eval) rendering: hierarchical coarse+fine, in tiles of rays.

Port of ``nerf_sandbox_tpu/render/renderer.py`` (reference
``nerf_sandbox/source/utils/render_utils.py:285-527``), hierarchical mode:
uniform coarse z (optional perturb), deterministic inverse-CDF fine sampling
on averaged interval weights, the fine pass over the merged samples writes
rgb/acc/depth; WORLD unit view directions feed the MLP while marching happens
in world or NDC space. ``eval_chunk`` is the per-tile ray count.

``EvalHyper.use_kernel`` selects the fused K2 ray-march kernel
(``ops/fused_raymarch.py``) for both passes, as the JAX ``use_pallas`` does;
``use_kernel=False`` is the plain path (``nerf_forward_pass`` with the MLP in
``compute_dtype``). Both take the k-planes encoder (``pos_encoder="kplanes"``,
``enc_cfg``, the models' ``pos_grid``), mip-NeRF's integrated positional
encoding (``ipe``, with the per-ray pixel-cone radii that ``render_pose``
computes), the mip-NeRF 360 contraction and, for 4-D grids, the frame's
time. On the kernel path a render packs each model
once (``render_tile.prepare``), its 4-D grid folded at the frame's time.
PyTorch runs eagerly, so a tile is a Python call, not a compiled program;
the occupancy and proposal sampling modes raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nerf_sandbox_tpu_torch.core.encoding import encode_dirs, pixel_cone_radii
from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
from nerf_sandbox_tpu_torch.core.sampling import (
    merge_z_samples, perturb_z_samples, resample_midpoints, stratified_samples)
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.forward import (
    check_ported_forward, nerf_forward_pass)
from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
from nerf_sandbox_tpu_torch.ops.fused_mlp import PackedMLP, pack_nerf_params
from nerf_sandbox_tpu_torch.ops.fused_raymarch import fused_raymarch
from nerf_sandbox_tpu_torch.ops.kplanes_encode import PackedKPlanes, pack_kplanes


class EvalHyper(NamedTuple):
    """Static eval configuration (the JAX ``EvalHyper`` minus unported modes)."""

    model: NeRFConfig
    nc_eval: int = 64
    nf_eval: int = 128
    white_bkgd: bool = True
    sigma_activation: str = "relu"
    infinite_last_bin: bool = True
    samp_near: float = 2.0
    samp_far: float = 6.0
    perturb: bool = False
    pos_include_input: bool = True
    dir_include_input: bool = True
    compute_dtype: str = "bfloat16"
    # the fused K2 ray-march kernel (encode + MLP + composite) for both passes
    use_kernel: bool = False
    # refine only the ceil(frac*T) rays with the highest coarse opacity; the
    # rest keep the coarse composite. 1.0 = reference semantics.
    eval_fine_frac: float = 1.0
    # early ray termination inside K2 (error bound eps per channel); 0.0 =
    # march every sample. Only the kernel path uses it.
    eval_ert_eps: float = 0.0
    pos_encoder: str = "freq"
    enc_cfg: object = None            # KPlanesConfig for pos_encoder="kplanes"
    sampling_mode: str = "hierarchical"
    scene_contraction: bool = False
    lindisp: bool = False
    ipe: bool = False
    dir_encoder: str = "freq"


class KernelModel(NamedTuple):
    """A model packed for K2 once per render: its MLP and, for k-planes, its
    grid (a 4-D grid folded at the frame's time)."""

    mlp: PackedMLP
    grid: PackedKPlanes | None


def make_tile_renderer(hyper: EvalHyper, pos_bands, dir_bands, *, device=None):
    """→ ``render_tile(model_c, model_f, ro, rd, rn, vd, generator=None,
    t=None, radii=None)`` returning (rgb (T,3), acc (T,1), depth (T,1)) for
    one tile of rays; ``t`` (T,) are the rays' normalised times, needed by
    4-D k-planes; ``radii`` (T,) or (T,1) the pixel-cone radii, needed by IPE.

    Runs on ``cuda`` unless ``device="cpu"``; the tile renderer's device is
    ``render_tile.device``. ``render_tile.prepare(model, t=None)`` packs a
    model for the kernel path (a :class:`KernelModel`, which ``render_tile``
    also takes); on the plain path it returns the model as it is.
    """
    if hyper.sampling_mode != "hierarchical":
        item = {"occupancy": "P7 item 3", "proposal": "P7 item 4"}.get(
            hyper.sampling_mode, "P7")
        raise NotImplementedError(
            f"sampling_mode={hyper.sampling_mode!r} is ROADMAP queue 1, {item}")
    check_ported_forward(pos_encoder=hyper.pos_encoder, ipe=hyper.ipe,
                         dir_encoder=hyper.dir_encoder)
    kp = hyper.pos_encoder == "kplanes"
    if kp:
        if not isinstance(hyper.enc_cfg, KPlanesConfig):
            raise ValueError("pos_encoder='kplanes' needs enc_cfg=KPlanesConfig(...)")
        if hyper.enc_cfg.out_dim != hyper.model.enc_pos_dim:
            raise ValueError(f"k-planes out_dim {hyper.enc_cfg.out_dim} != "
                             f"enc_pos_dim {hyper.model.enc_pos_dim}")
    dynamic = kp and hyper.enc_cfg.time_res > 0
    dev = resolve_device(device)
    pos_bands = np.asarray(pos_bands, np.float32)
    dir_bands = np.asarray(dir_bands, np.float32)
    compute_dtype = getattr(torch, hyper.compute_dtype)

    def prepare(model, t=None):
        if not hyper.use_kernel or model is None or isinstance(model, KernelModel):
            return model
        grid = pack_kplanes(model.pos_grid, hyper.enc_cfg, t=t) if kp else None
        return KernelModel(pack_nerf_params(model), grid)

    def forward(model, ro, rd, rn, vd, z, t, radii):
        if hyper.use_kernel:
            km = prepare(model, t)
            vn = torch.linalg.vector_norm(vd, dim=-1, keepdim=True)
            enc_dir = encode_dirs(vd / torch.clamp(vn, min=1e-12), dir_bands,
                                  include_input=hyper.dir_include_input)
            return fused_raymarch(
                km.mlp, ro, rd, z, rn, enc_dir, None if kp else pos_bands,
                pos_include_input=hyper.pos_include_input,
                sigma_activation=hyper.sigma_activation,
                white_bkgd=hyper.white_bkgd,
                infinite_last_bin=hyper.infinite_last_bin,
                ert_eps=hyper.eval_ert_eps,
                scene_contraction=hyper.scene_contraction,
                kp_params=km.grid, kp_cfg=hyper.enc_cfg if kp else None,
                ipe_radii=radii, device=dev)
        return nerf_forward_pass(
            model, ro, rd, z, pos_bands=pos_bands, dir_bands=dir_bands,
            pos_include_input=hyper.pos_include_input,
            dir_include_input=hyper.dir_include_input,
            white_bkgd=hyper.white_bkgd, ray_norms=rn,
            viewdirs_world_unit=vd, sigma_activation=hyper.sigma_activation,
            infinite_last_bin=hyper.infinite_last_bin,
            compute_dtype=compute_dtype, pos_encoder=hyper.pos_encoder,
            enc_cfg=hyper.enc_cfg, scene_contraction=hyper.scene_contraction,
            ipe=hyper.ipe, radii=radii, t=t, device=dev)

    @torch.no_grad()
    def render_tile(model_c, model_f, rays_o, rays_d_unit, ray_norms, viewdirs,
                    generator: torch.Generator | None = None, t=None,
                    radii=None):
        T = rays_o.shape[0]
        t = t if dynamic else None
        if not hyper.ipe:
            radii = None
        elif radii is None:
            raise ValueError("EvalHyper.ipe needs per-ray radii")
        z = stratified_samples(hyper.samp_near, hyper.samp_far, hyper.nc_eval,
                               lindisp=hyper.lindisp, device=dev)
        z = z.expand(T, hyper.nc_eval)
        if hyper.perturb:
            z = perturb_z_samples(z, generator=generator)

        comp_c, w_c, acc_c, depth_c = forward(model_c, rays_o, rays_d_unit,
                                              ray_norms, viewdirs, z, t, radii)
        if hyper.nf_eval <= 0 or model_f is None:
            return comp_c, acc_c, depth_c

        frac = float(hyper.eval_fine_frac)
        if 0.0 < frac < 1.0:
            # Fine-ray culling: refine only the K rays with the highest
            # coarse opacity (K rounded to 8 as in the JAX renderer).
            m = 8
            K = min(T, max(m, -(-int(T * frac) // m) * m))
            top = torch.argsort(-acc_c[:, 0], stable=True)[:K]
            z_s = z[top]
            zf = resample_midpoints(z_s, w_c[top], hyper.nf_eval,
                                    deterministic=True)
            comp_s, _, acc_s, depth_s = forward(
                model_f, rays_o[top], rays_d_unit[top], ray_norms[top],
                viewdirs[top], merge_z_samples(z_s, zf),
                None if t is None else t[top],
                None if radii is None else radii[top])
            comp_f, acc_f, depth_f = comp_c.clone(), acc_c.clone(), depth_c.clone()
            comp_f[top], acc_f[top], depth_f[top] = comp_s, acc_s, depth_s
            return comp_f, acc_f, depth_f

        zf = resample_midpoints(z, w_c, hyper.nf_eval, deterministic=True)
        comp_f, _, acc_f, depth_f = forward(model_f, rays_o, rays_d_unit,
                                            ray_norms, viewdirs,
                                            merge_z_samples(z, zf), t, radii)
        return comp_f, acc_f, depth_f

    render_tile.device = dev
    render_tile.ipe = hyper.ipe
    render_tile.prepare = prepare
    return render_tile


def _check_tile_device(render_tile, device) -> torch.device:
    dev = resolve_device(device)
    if render_tile.device != dev:
        raise ValueError(f"tile renderer runs on {render_tile.device}, "
                         f"asked to render on {dev}")
    return dev


def render_rays_chunked(render_tile, model_c, model_f, rays_o, rays_d_unit,
                        ray_norms, viewdirs, *, eval_chunk: int = 16384,
                        generator: torch.Generator | None = None, t=None,
                        radii=None, device=None) -> dict:
    """Render any number of rays in fixed tiles → {rgb, acc, depth} tensors.

    The last tile is padded by WRAPPING the leading rays (JAX
    renderer.py:361-367): duplicated real rays rank exactly like their
    originals under ``eval_fine_frac`` culling, and their outputs are cut.
    ``t`` (n,) are the rays' normalised times (4-D k-planes), ``radii`` (n,)
    or (n, 1) their pixel-cone radii (IPE). The models are packed for the
    kernel once, before the first tile.
    """
    dev = _check_tile_device(render_tile, device)
    n = rays_o.shape[0]
    tile = min(int(eval_chunk), n) if eval_chunk else n
    n_pad = (-n) % tile

    def pad(x):
        x = x.to(dev, torch.float32)
        return torch.cat([x, x[:n_pad]]) if n_pad else x

    ro, rd, vd = pad(rays_o), pad(rays_d_unit), pad(viewdirs)
    rn = pad(ray_norms.reshape(n, 1))
    tt = None if t is None else pad(t.reshape(n))
    ra = None if radii is None else pad(radii.reshape(n, 1))
    model_c = render_tile.prepare(model_c, tt)
    model_f = render_tile.prepare(model_f, tt)

    outs = {"rgb": [], "acc": [], "depth": []}
    for i in range(0, n + n_pad, tile):
        rgb, acc, depth = render_tile(model_c, model_f, ro[i:i + tile],
                                      rd[i:i + tile], rn[i:i + tile],
                                      vd[i:i + tile], generator,
                                      None if tt is None else tt[i:i + tile],
                                      None if ra is None else ra[i:i + tile])
        outs["rgb"].append(rgb)
        outs["acc"].append(acc)
        outs["depth"].append(depth)
    return {k: torch.cat(v)[:n] for k, v in outs.items()}


def render_pose(render_tile, model_c, model_f, c2w, H: int, W: int, K, *,
                eval_chunk: int = 16384, use_ndc: bool = False,
                convention: str = "opengl", near_plane: float = 1.0,
                generator: torch.Generator | None = None,
                time: float | None = None, device=None) -> dict:
    """Render one camera pose → numpy {rgb (H,W,3), acc (H,W,1), depth (H,W,1)}.

    WORLD rays feed the MLP's view-direction branch; marching rays are NDC
    when requested (render_utils.py:426-527 semantics). ``time``: the frame's
    normalised capture time, given to every ray (4-D k-planes; ignored by
    static renderers). Outside NDC every ray carries its pixel-cone radius
    (JAX renderer.py:408-413), which an IPE tile renderer encodes; IPE with
    NDC raises, as the radii are undefined after the warp.
    """
    dev = _check_tile_device(render_tile, device)
    if use_ndc and render_tile.ipe:
        raise ValueError("IPE needs pixel-cone radii, which are undefined "
                         "after the NDC warp")
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    rays = get_camera_rays_grid(K, c2w, image_h=H, image_w=W,
                                convention=convention, pixel_center=True,
                                as_ndc=use_ndc, near_plane=float(near_plane))
    radii = None
    if not use_ndc:
        radii = pixel_cone_radii(K[0, 0], rays.d_world_norm[..., 0])
    t = None
    if time is not None:
        t = torch.full((rays.o_march.shape[0],), float(time),
                       dtype=torch.float32, device=dev)
    out = render_rays_chunked(render_tile, model_c, model_f, rays.o_march,
                              rays.d_march_unit, rays.d_march_norm,
                              rays.d_world_unit, eval_chunk=eval_chunk,
                              generator=generator, t=t, radii=radii,
                              device=dev)
    return {"rgb": out["rgb"].cpu().numpy().reshape(H, W, 3),
            "acc": out["acc"].cpu().numpy().reshape(H, W, 1),
            "depth": out["depth"].cpu().numpy().reshape(H, W, 1)}
