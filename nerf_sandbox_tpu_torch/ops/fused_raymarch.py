"""K2: the fused eval ray-march (``csrc/fused_raymarch.cu``), with K2c, K3 and K4.

Replaces the TPU kernel ``nerf_sandbox_tpu/ops/fused_raymarch.py:fused_raymarch``
(Pallas bodies ``_kernel`` / ``_kernel_chunk_body``): per ray,
``pts = o + d̂·z·‖d‖`` → [K2c: the mip-NeRF 360 contraction of the points]
→ the fp32 sin/cos encode or [K3: the k-planes encode, ``ops/kplanes_encode.py``]
or [K4: mip-NeRF's integrated positional encoding, each sample a
conical-frustum Gaussian over its interval, lifted to a diagonal Gaussian or
pushed through the contraction's closed-form Jacobian, each sin/cos column
attenuated by ``exp(-½f²σ²)``] → the K1 MLP → sigmoid rgb, relu/softplus σ
→ ``α = 1-exp(-clip(σΔ,0,60))`` → ``T = exp(Σ log(1-α+1e-10))`` → per-sample weights and per-ray Σw, Σw·z,
Σw·rgb (+ white background), with optional early ray termination (ERT).

Bound on the H100: the MLP's ~1.2 MFLOP of bf16 work per sample against
about 10 bytes of HBM traffic per sample, so the tensor cores set the bound:
one 16384×192 fine tile is 3.73 TFLOP (3.76 at the k-planes width 71), 3.8
ms at 989 TFLOP/s. Design (``csrc/fused_raymarch.cu``): one persistent block
per SM walks groups of 32 rays; each of its two consumer warpgroups owns 16
rays and loops over their samples 4 at a time, 64 rows per pass of the
``wgmma`` MLP (both share each weight stage: 128 rows per fetch from L2),
with the per-ray accumulators in registers — the TPU's sequential-grid carry
becomes a loop inside the block — and ERT ends a group once all its rays
have T < eps. The encoder, the contraction and the hidden width (128, 256,
384 or 512; the last two on the wide path of ``csrc/mlp_tile.cuh``; every
wider multiple of 128 on its large route, one instantiation for all) are
template parameters of the kernel.

:func:`fused_raymarch_plain` is the same function in plain PyTorch with the
kernel's bf16 rounding points; it marches every sample (ERT changes each
output by less than ``ert_eps`` per channel). :func:`fused_raymarch` takes it
only for CPU tensors; for CUDA tensors it launches the kernel or raises, and
counts the launch in ``fused_raymarch.launches``, per route (``freq``,
``kplanes`` or ``ipe``: the encoder; ``contract``, ``tfold``, ``large``: the
other branches the launch ran) in ``fused_raymarch.route_launches``, and per
encoder and samples a ray (``("kplanes", 64)``: a 64-sample coarse tile) in
``fused_raymarch.tile_launches``.

K4 computes each sample's interval from its neighbours in the kernel (the
row of z is in device memory; the TPU streamed μ and the half-width because
a chunk cannot see its neighbours), so the IPE launch reads no more than a
frequency launch besides the per-ray radius.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nerf_sandbox_tpu_torch.core.encoding import (
    conical_frustum_moments, integrated_positional_encoding, lift_gaussian_diag,
    positional_encoding, scene_contract, z_to_intervals)
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
from nerf_sandbox_tpu_torch.ops import cuda_build
from nerf_sandbox_tpu_torch.ops.fused_mlp import (
    PLAIN_ROWS, PackedMLP, _enc_pads, _ptr, as_packed, check_kernel_shape,
    is_large, large_scratch, mlp_rows_plain, offsets_arg, pad_cols_bf16)
from nerf_sandbox_tpu_torch.ops.kplanes_encode import (
    KP_C_ARGTYPES, PackedKPlanes, check_kernel_shapes, kp_c_args,
    kplanes_encode_plain, pack_kplanes)

RAYS_PER_GROUP = 32          # csrc/fused_raymarch.cu: RAYS
SAMPLES_PER_PASS = 4         # csrc/fused_raymarch.cu: SPC
MAX_BANDS = 32               # csrc/fused_raymarch.cu: MAX_BANDS
ROUTES = ("freq", "kplanes", "ipe", "contract", "tfold", "large")


def _deltas(z_vals: torch.Tensor, ray_norms: torch.Tensor,
            infinite_last_bin: bool) -> torch.Tensor:
    """Δ = diff(z) with the last bin, × ‖d‖ (JAX fused_raymarch.py:592-595)."""
    B = z_vals.shape[0]
    d_fin = z_vals[:, 1:] - z_vals[:, :-1]
    d_last = torch.full_like(z_vals[:, :1], 1e10 if infinite_last_bin else 0.0)
    return torch.cat([d_fin, d_last], dim=1) * ray_norms.reshape(B, 1)


def contract_gaussian_closed_form(mean, d_unit, t_var, r_var):
    """K4's pushforward of frustum Gaussians through the contraction, with
    the Pallas body's closed-form Jacobian (JAX fused_raymarch.py:456-474):
    for n = ‖x‖ > 1, J = s·I + c·xxᵀ with s = 2/n − 1/n², c = 2(1−n)/n⁴, so
    Jd = s·d + c·x(x·d) and rowsum(J∘J) = s² + 2scx² + c²x²n²; J = I inside
    the unit ball. ``mean`` (b, N, 3), ``d_unit`` (b, 3), ``t_var``/``r_var``
    (b, N) → (contracted mean, var_diag), each (b, N, 3)."""
    x, d = mean, d_unit[:, None, :]
    n2 = torch.clamp(torch.sum(x * x, dim=-1, keepdim=True), min=1e-18)
    n = torch.sqrt(n2)
    s = 2.0 / n - 1.0 / n2
    c = 2.0 * (1.0 - n) / (n2 * n2)
    xd = torch.sum(x * d, dim=-1, keepdim=True)
    inside = n <= 1.0
    jd = torch.where(inside, d, s * d + c * x * xd)
    row2 = torch.where(inside, 1.0, s * s + 2.0 * s * c * x * x + c * c * x * x * n2)
    var = (t_var[..., None] * jd ** 2
           + r_var[..., None] * torch.clamp(row2 - jd ** 2, min=0.0))
    return torch.where(inside, x, (2.0 - 1.0 / n) * (x / n)), var


def ipe_gaussians(rays_o, rays_d_unit, z_metric, radii, contract: bool):
    """K4's per-sample Gaussians: intervals from the neighbouring samples
    (JAX fused_raymarch.py:634-642), the frustum moments, then the diagonal
    lift or the closed-form pushforward (:446-478). ``z_metric`` (b, N),
    N >= 2, ``radii`` (b,) → (mean, var_diag), each (b, N, 3)."""
    lower, upper = z_to_intervals(z_metric)
    t_mean, t_var, r_var = conical_frustum_moments(lower, upper,
                                                   radii.reshape(-1, 1))
    mean, var = lift_gaussian_diag(rays_d_unit, t_mean, t_var, r_var, rays_o)
    if contract:
        return contract_gaussian_closed_form(mean, rays_d_unit, t_var, r_var)
    return mean, var


def fused_raymarch_plain(packed: PackedMLP, rays_o, rays_d_unit, z_vals, dt,
                         ray_norms, enc_dir, pos_bands, *,
                         pos_include_input: bool = True,
                         sigma_activation: str = "relu",
                         white_bkgd: bool = True, contract: bool = False,
                         kp: PackedKPlanes | None = None, radii=None):
    """K2's plain PyTorch version, on any device → (raw (B, 5), w (B, N)).

    ``raw`` holds Σw·rgb (+ background), clipped Σw and Σw·z per ray, as the
    kernel writes them. ``contract`` warps the points (K2c); ``kp`` encodes
    them with the packed k-planes tables (K3) instead of ``pos_bands``;
    ``radii`` (B,) encodes each sample's frustum Gaussian instead (K4, fp32,
    then one bf16 cast), contracted by the closed-form pushforward when
    ``contract``. Rays are processed in chunks of about 2^18 samples.
    """
    B, N = z_vals.shape
    ep_pad, ed_pad = _enc_pads(packed.cfg)
    ed_all = pad_cols_bf16(enc_dir.to(torch.bfloat16), ed_pad)
    step = max(1, PLAIN_ROWS // N)
    raws, ws = [], []
    for i in range(0, B, step):
        sl = slice(i, i + step)
        z = z_vals[sl]
        b = z.shape[0]
        zm = z * ray_norms[sl].reshape(b, 1)
        if radii is not None:
            mean, var = ipe_gaussians(rays_o[sl], rays_d_unit[sl], zm,
                                      radii[sl], contract)
            enc = integrated_positional_encoding(
                mean.reshape(-1, 3), var.reshape(-1, 3), pos_bands,
                include_input=pos_include_input)
            ep = pad_cols_bf16(enc.to(torch.bfloat16), ep_pad)
        else:
            pts = (rays_o[sl, None, :] + rays_d_unit[sl, None, :] * zm[..., None]
                   ).reshape(-1, 3)
            if contract:
                pts = scene_contract(pts)
            if kp is not None:
                ep = kplanes_encode_plain(kp, pts, ep_pad)
            else:
                enc = positional_encoding(pts, pos_bands,
                                          include_input=pos_include_input)
                ep = pad_cols_bf16(enc.to(torch.bfloat16), ep_pad)
        ed = ed_all[sl].repeat_interleave(N, dim=0)
        out = mlp_rows_plain(packed, ep, ed)
        rgb = torch.sigmoid(out[:, :3]).reshape(b, N, 3)
        sig = out[:, 3].reshape(b, N)
        sig = (torch.nn.functional.softplus(sig) if sigma_activation == "softplus"
               else torch.relu(sig))
        one_m_alpha = torch.exp(-torch.clamp(sig * dt[sl], 0.0, 60.0))
        lg = torch.log(one_m_alpha + 1e-10)
        log_t = torch.cat([torch.zeros_like(lg[:, :1]),
                           torch.cumsum(lg, dim=1)[:, :-1]], dim=1)
        w = torch.exp(log_t) * (1.0 - one_m_alpha)
        acc = torch.clamp(w.sum(dim=1, keepdim=True), 0.0, 1.0)
        comp = (w[..., None] * rgb).sum(dim=1)
        if white_bkgd:
            comp = comp + (1.0 - acc)
        raws.append(torch.cat([comp, acc, (w * z).sum(dim=1, keepdim=True)], 1))
        ws.append(w)
    return torch.cat(raws), torch.cat(ws)


def _launch(packed: PackedMLP, rays_o, rays_d_unit, z_vals, ray_norms,
            enc_dir, bands: np.ndarray, *, pos_include_input: bool,
            sigma_activation: str, white_bkgd: bool, infinite_last_bin: bool,
            ert_eps: float, contract: bool, kp: PackedKPlanes | None, radii):
    """Launch K2 on the current stream (inputs on one CUDA device); the
    kernel forms the deltas of :func:`_deltas` itself."""
    cfg = packed.cfg
    B, N = z_vals.shape
    dev = z_vals.device
    f32 = [t.to(torch.float32).contiguous()
           for t in (rays_o, rays_d_unit, ray_norms.reshape(B), enc_dir,
                     z_vals)]
    if radii is not None:
        radii = radii.contiguous()
    on_card = (f32 + [packed.flat, packed.staged]
               + ([kp.flat] if kp is not None else [])
               + ([radii] if radii is not None else []))
    if any(t.device != dev or t.device.type != "cuda" for t in on_card):
        raise ValueError("fused_raymarch: all tensors must be on one CUDA device")
    ro, rd, rn, ed, z = f32
    if ro.shape != (B, 3) or rd.shape != (B, 3) or ed.shape != (B, cfg.enc_dir_dim):
        raise ValueError("fused_raymarch: bad ray shapes "
                         f"{tuple(ro.shape)}, {tuple(rd.shape)}, {tuple(ed.shape)}")
    check_kernel_shape(cfg)
    ep_pad, ed_pad = _enc_pads(cfg)
    if kp is not None:
        check_kernel_shapes(kp, ep_pad)
        if kp.cfg.out_dim != cfg.enc_pos_dim:
            raise ValueError("fused_raymarch: the k-planes rows do not give "
                             "enc_pos_dim")
        kp_args = kp_c_args(kp)
        bands = np.zeros(0, np.float32)
    else:
        if bands.size > MAX_BANDS:
            raise ValueError(f"fused_raymarch: at most {MAX_BANDS} bands")
        if (3 if pos_include_input else 0) + 6 * bands.size != cfg.enc_pos_dim:
            raise ValueError("fused_raymarch: pos_bands do not give enc_pos_dim")
        kp_args = [None, None, None, 0, 0, 0, 0, 0, 0.0, None, 0]
    out_ray = torch.empty((B, 5), dtype=torch.float32, device=dev)
    out_w = torch.empty((B, N), dtype=torch.float32, device=dev)
    lib = cuda_build.load("fused_raymarch")
    large = is_large(cfg)
    fn = lib.nerf_fused_raymarch_large if large else lib.nerf_fused_raymarch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
                   + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                   + KP_C_ARGTYPES
                   + ([ctypes.c_void_p, ctypes.c_int] if large else [])
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    extra = []
    if large:
        scratch, blocks = large_scratch(cfg, dev)
        extra = [_ptr(scratch), blocks]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(ro), _ptr(rd), _ptr(rn), _ptr(ed), _ptr(z), int(infinite_last_bin),
             (ctypes.c_float * max(1, bands.size))(*bands.tolist()),
             int(bands.size), int(pos_include_input), _ptr(packed.flat),
             offsets_arg(packed), _ptr(packed.staged), B, N, cfg.enc_dir_dim,
             cfg.hidden_dim,
             ep_pad, ed_pad, cfg.n_layers, cfg.skip_pos,
             int(sigma_activation == "softplus"), int(white_bkgd),
             int(ert_eps > 0.0),
             float(np.log(ert_eps)) if ert_eps > 0.0 else 0.0,
             int(contract), None if radii is None else _ptr(radii), *kp_args,
             *extra, _ptr(out_ray), _ptr(out_w), ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "fused_raymarch kernel launch")
    fused_raymarch.launches += 1
    routes = fused_raymarch.route_launches
    enc = "kplanes" if kp is not None else "ipe" if radii is not None else "freq"
    routes[enc] += 1
    tiles = fused_raymarch.tile_launches
    tiles[enc, N] = tiles.get((enc, N), 0) + 1
    routes["contract"] += int(contract)
    routes["tfold"] += int(kp is not None and kp.t is not None)
    routes["large"] += int(large)
    return out_ray, out_w


def fused_raymarch(model: NeRFMLP | PackedMLP, rays_o, rays_d_unit, z_vals, ray_norms,
                   enc_dir, pos_bands=None, *, pos_include_input: bool = True,
                   sigma_activation: str = "relu", white_bkgd: bool = True,
                   infinite_last_bin: bool = True, ert_eps: float = 0.0,
                   scene_contraction: bool = False, kp_params=None,
                   kp_cfg=None, kp_t=None, ipe_radii=None, device=None):
    """Fused eval forward → (comp (B,3), weights (B,N), acc (B,1), depth (B,1)).

    ``enc_dir`` is the per-RAY encoded view direction (B, enc_dir_dim);
    ``pos_bands`` (F,) the position frequency bands. Matches
    ``nerf_forward_pass`` + ``volume_render_rays`` eval semantics with bf16
    MLP products. ``ert_eps`` > 0 enables early ray termination (each output
    moves by less than ``ert_eps`` per channel; skipped weights are 0).

    ``scene_contraction`` warps the points before the encode (K2c).
    ``ipe_radii`` (B,) or (B, 1) pixel-cone radii switch the frequency
    encode to mip-NeRF's integrated positional encoding of each sample's
    frustum Gaussian (K4; needs N >= 2), pushed through the contraction's
    Jacobian under ``scene_contraction``. ``kp_params`` (a ``KPlanes``, a
    dict of its tables, or a :class:`PackedKPlanes` packed once per render)
    with ``kp_cfg`` replaces the frequency encoder by the k-planes encode
    (K3); a 4-D model folds its time planes at the frame's time ``kp_t``.

    Runs on ``cuda`` (the K2 kernel) unless ``device="cpu"`` (the plain
    version); the model's parameters (or its :class:`PackedMLP`) and the
    tables must already be on that device.
    """
    dev = resolve_device(device)
    packed = as_packed(model)
    if packed.flat.device.type != dev.type:
        raise ValueError(f"model is on {packed.flat.device}, asked to run on {dev}")
    kp = None
    if kp_params is not None or kp_cfg is not None:
        if kp_params is None or kp_cfg is None:
            raise ValueError("the k-planes encode needs kp_params and kp_cfg")
        if isinstance(kp_params, PackedKPlanes):
            if kp_t is not None:
                raise ValueError("packed kp_params carry their own time; pass "
                                 "kp_t only with unpacked tables")
            kp = kp_params
        else:
            kp = pack_kplanes(kp_params, kp_cfg, t=kp_t)
        if kp.flat.device.type != dev.type:
            raise ValueError(f"tables are on {kp.flat.device}, asked to run on {dev}")
    rays_o, rays_d_unit, z_vals, ray_norms, enc_dir = (
        t.to(dev, torch.float32)
        for t in (rays_o, rays_d_unit, z_vals, ray_norms, enc_dir))
    radii = None
    if ipe_radii is not None:
        if kp is not None:
            raise ValueError("IPE applies to the frequency encoder only; got "
                             "ipe_radii with kp_params")
        B, N = z_vals.shape
        radii = torch.as_tensor(ipe_radii).to(dev, torch.float32)
        if tuple(radii.shape) not in ((B,), (B, 1)):
            raise ValueError(f"ipe_radii must be ({B},) or ({B}, 1), got "
                             f"{tuple(radii.shape)}")
        if N < 2:
            raise ValueError("IPE needs at least two samples per ray")
        radii = radii.reshape(B)
    bands = np.asarray([] if pos_bands is None else pos_bands,
                       np.float32).reshape(-1)
    kw = dict(pos_include_input=pos_include_input,
              sigma_activation=sigma_activation, white_bkgd=white_bkgd,
              contract=bool(scene_contraction), kp=kp, radii=radii)
    if dev.type == "cpu":
        dt = _deltas(z_vals, ray_norms, infinite_last_bin)
        raw, w = fused_raymarch_plain(packed, rays_o, rays_d_unit, z_vals, dt,
                                      ray_norms, enc_dir, bands, **kw)
    else:
        raw, w = _launch(packed, rays_o, rays_d_unit, z_vals, ray_norms,
                         enc_dir, bands, infinite_last_bin=infinite_last_bin,
                         ert_eps=ert_eps, **kw)
    return fixup_outputs(raw, w)


def fixup_outputs(raw: torch.Tensor, w: torch.Tensor):
    """Kernel/plain raw outputs → (comp, weights, acc, depth), with the JAX
    wrapper's fix-up (fused_raymarch.py:698-704)."""
    comp = torch.clamp(torch.nan_to_num(raw[:, 0:3], nan=0.0, posinf=1.0,
                                        neginf=0.0), 0.0, 1.0)
    acc = raw[:, 3:4]
    depth = raw[:, 4:5] / (acc + 1e-10)
    w = torch.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)
    return comp, w, acc, depth


def reset_launches() -> None:
    """Set K2's launch counts, the total, each route's and each tile
    shape's, to 0."""
    fused_raymarch.launches = 0
    fused_raymarch.route_launches = dict.fromkeys(ROUTES, 0)
    fused_raymarch.tile_launches = {}


reset_launches()
