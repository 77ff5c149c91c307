"""K3: the k-planes encode of the fused eval kernel (``csrc/kplanes_encode.cuh``).

Replaces the TPU kernel's k-planes branch,
``nerf_sandbox_tpu/ops/fused_raymarch.py:_kp_encode_body`` with its table
packing ``_kp_pack_tables`` (static, and the 4-D fold at a fixed time):
world points (Q, 3) → (Q, EP_PAD) bf16 encoder rows
``[scale0 F, scale1 F, ..., line Fl, hybrid 3+6L, 0...]``.

* ``x01 = clip(p / (2·aabb) + 0.5, 0, 1)``; per axis and resolution R the
  hat weights of ``u = x01·(R-1)``, ``i0 = min(floor(u), R-2)``, are
  ``1-|u-i0|`` and ``1-|u-i0-1|`` rounded to bf16, as the TPU's hat rows are.
* Per scale: the product of the three bilinear plane lookups (xy, xz, yz:
  the first named axis indexes the table's first axis), times, for a 4-D
  model, the three 1-D lookups of its time-folded (R, F) tables; then the
  product of the three CP line lookups (``line_x`` carries the folded time
  line); then the hybrid channels ``[u, sin(f·u), cos(f·u)]`` of
  ``u = 2·x01-1`` with bands 2^0..2^(L-1).
* Products of bf16 weights and bf16 texels, sums and the feature products
  are fp32; the row is rounded to bf16 once (the Pallas rounding points:
  ``dot(..., preferred_element_type=f32)`` then one ``astype(bf16)``).

On the H100 the TPU's one-hot MXU interpolation (2·Q·R²·F FLOPs) becomes four
texel reads per plane: the bf16 tables (1.03 MB at full width) stay in L2,
and one 8-feature texel is one 16-byte load (other feature widths read and
write groups of 4, 2 or 1 values, with the same arithmetic). Per sample the encode reads
about 576 B from L2 and writes EP_PAD·2 bytes; inside K2 the rows stay in
shared memory. The encode-only launch here (``fused_kplanes_encode``) is the
same ``__device__`` function over Q rows, written to device memory: bound by
those writes.

:func:`pack_kplanes` builds the kernels' one bf16 buffer, once per render
(the 4-D fold depends on the frame's time). :func:`kplanes_encode_plain` is
the same function in plain PyTorch, with dense hat matrices on fp32 copies
of the bf16 values, chunked over rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nerf_sandbox_tpu_torch.core.encoding import (
    make_frequency_bands, positional_encoding)
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.kplanes import (
    PLANES, KPlanes, KPlanesConfig, _interp_weights)
from nerf_sandbox_tpu_torch.ops import cuda_build
from nerf_sandbox_tpu_torch.ops.fused_mlp import _ptr, pad_cols_bf16

MAX_SCALES = 4               # csrc/kplanes_encode.cuh: KP_MAX_SCALES
MAX_BANDS = 32               # csrc/kplanes_encode.cuh: KP_MAX_BANDS
PLAIN_ROWS = 1 << 15         # row chunk of the plain version (bounds memory)
_ALIGN = 64                  # tables start on 128-byte boundaries
AXES = ("x", "y", "z")


class PackedKPlanes(NamedTuple):
    """The k-planes tables as one bf16 buffer (the kernels' argument) plus a
    named view of each: ``plane{s}_{xy,xz,yz}`` (R, R, F), for 4-D models
    ``fold{s}_{x,y,z}`` (R, F) at time ``t``, and ``line_{x,y,z}`` (L, Fl).
    ``offsets`` are element offsets in that order."""

    cfg: KPlanesConfig
    flat: torch.Tensor
    offsets: tuple
    views: dict
    t: float | None

    @property
    def bands(self):
        return make_frequency_bands(self.cfg.hybrid_freqs)


def _table_shapes(cfg: KPlanesConfig) -> dict:
    F = cfg.plane_features
    shapes = {}
    for s, R in enumerate(cfg.plane_res):
        for name, _ in PLANES:
            shapes[f"plane{s}_{name}"] = (R, R, F)
    if cfg.time_res > 0:
        for s, R in enumerate(cfg.plane_res):
            for ax in AXES:
                shapes[f"fold{s}_{ax}"] = (R, F)
    for ax in AXES:
        shapes[f"line_{ax}"] = (cfg.line_res, cfg.line_features)
    return shapes


def _frame_time(t) -> float:
    """The one time of a frame: a number, or per-ray times that are all equal."""
    if not torch.is_tensor(t):
        return float(t)
    t0 = t.reshape(-1)[0]
    if not bool(torch.all(t == t0)):
        raise ValueError("the kernels fold a 4-D grid at one frame time: "
                         "all t must be equal")
    return float(t0)


@torch.no_grad()
def pack_kplanes(kp, kp_cfg: KPlanesConfig, t=None) -> PackedKPlanes:
    """Pack a :class:`KPlanes` (or a dict of its tables) for the kernels
    (``_kp_pack_tables``, fused_raymarch.py:158-208). Planes keep the JAX
    (R, R, F) layout. A 4-D model needs the frame's normalised time ``t`` (a
    number, or per-ray times that are all equal; a static model ignores it):
    its space-time planes fold to ``Σ_τ hat(t)_τ P[:, τ, :]`` and ``line_x``
    is scaled by ``hat(t)·line_t``, both in fp32 before the bf16 cast."""
    tables = kp.tables() if isinstance(kp, KPlanes) else kp
    dyn = kp_cfg.time_res > 0
    if dyn and t is None:
        raise ValueError("a 4-D k-planes fold needs the frame time t")
    dev = tables["line_x"].device
    src = {}
    for s, _ in enumerate(kp_cfg.plane_res):
        for name, _ in PLANES:
            src[f"plane{s}_{name}"] = tables[f"plane{s}_{name}"]
    line_scale = None
    if dyn:
        t = _frame_time(t)
        wt = _interp_weights(torch.tensor([t], dtype=torch.float32, device=dev),
                             int(kp_cfg.time_res))[0]                  # (T,)
        for s, _ in enumerate(kp_cfg.plane_res):
            for ax, name in zip(AXES, ("xt", "yt", "zt")):
                src[f"fold{s}_{ax}"] = torch.einsum(
                    "t,rtf->rf", wt, tables[f"plane{s}_{name}"].float())
        line_scale = wt @ tables["line_t"].float()                     # (Fl,)
    for ax in AXES:
        line = tables[f"line_{ax}"].float()
        src[f"line_{ax}"] = line * line_scale[None, :] if (
            ax == "x" and line_scale is not None) else line

    shapes = _table_shapes(kp_cfg)
    offsets, total = [], 0
    for name, shape in shapes.items():
        offsets.append(total)
        n = 1
        for d in shape:
            n *= d
        total += -(-n // _ALIGN) * _ALIGN
    flat = torch.zeros(total, dtype=torch.bfloat16, device=dev)
    views = {}
    for (name, shape), off in zip(shapes.items(), offsets):
        n = 1
        for d in shape:
            n *= d
        views[name] = flat[off:off + n].view(shape)
        views[name].copy_(src[name].reshape(shape))
    return PackedKPlanes(kp_cfg, flat, tuple(offsets), views,
                         t if dyn else None)


def _hat_bf16(x01: torch.Tensor, R: int) -> torch.Tensor:
    return _interp_weights(x01, R).to(torch.bfloat16).float()


def _encode_rows_plain(kp: PackedKPlanes, pts: torch.Tensor) -> torch.Tensor:
    cfg, v = kp.cfg, kp.views
    F = cfg.plane_features
    x01 = torch.clamp(pts / (2.0 * cfg.aabb_scale) + 0.5, 0.0, 1.0)
    feats = []
    for s, R in enumerate(cfg.plane_res):
        W = [_hat_bf16(x01[:, d], R) for d in range(3)]
        prod = None
        for name, (da, db) in PLANES:
            A = (W[da] @ v[f"plane{s}_{name}"].float().reshape(R, -1)).reshape(-1, R, F)
            f = (W[db][:, :, None] * A).sum(dim=1)
            prod = f if prod is None else prod * f
        if cfg.time_res > 0:
            for d, ax in enumerate(AXES):
                prod = prod * (W[d] @ v[f"fold{s}_{ax}"].float())
        feats.append(prod)
    line = None
    for d, ax in enumerate(AXES):
        lv = _hat_bf16(x01[:, d], cfg.line_res) @ v[f"line_{ax}"].float()
        line = lv if line is None else line * lv
    feats.append(line)
    if cfg.hybrid_freqs > 0:
        feats.append(positional_encoding(x01 * 2.0 - 1.0, kp.bands))
    return torch.cat(feats, dim=1)


def kplanes_encode_plain(kp: PackedKPlanes, pts: torch.Tensor,
                         ep_pad: int) -> torch.Tensor:
    """K3's plain PyTorch version, on any device: (Q, 3) fp32 points →
    (Q, ep_pad) bf16, in chunks of ``PLAIN_ROWS`` rows."""
    pts = pts.to(torch.float32)
    out = torch.zeros((pts.shape[0], ep_pad), dtype=torch.bfloat16,
                      device=pts.device)
    for i in range(0, pts.shape[0], PLAIN_ROWS):
        enc = _encode_rows_plain(kp, pts[i:i + PLAIN_ROWS])
        out[i:i + PLAIN_ROWS, :enc.shape[1]] = enc.to(torch.bfloat16)
    return out


def check_kernel_shapes(kp: PackedKPlanes, ep_pad: int) -> None:
    """Raise for k-planes shapes the CUDA kernels do not take."""
    cfg = kp.cfg
    if not 1 <= len(cfg.plane_res) <= MAX_SCALES:
        raise ValueError(f"the kernels take 1..{MAX_SCALES} plane scales")
    if cfg.plane_features < 1 or cfg.line_features < 1:
        raise ValueError("plane and line features must be >= 1")
    if min(cfg.plane_res) < 2 or cfg.line_res < 2:
        raise ValueError("plane and line resolutions must be >= 2")
    if cfg.hybrid_freqs > MAX_BANDS:
        raise ValueError(f"at most {MAX_BANDS} hybrid bands")
    if cfg.out_dim > ep_pad:
        raise ValueError(f"k-planes rows of {cfg.out_dim} do not fit {ep_pad}")


def kp_c_args(kp: PackedKPlanes) -> list:
    """The C arguments that describe the packed tables (kplanes_encode.cuh:
    make_kp_args), in order."""
    cfg = kp.cfg
    bands = kp.bands if cfg.hybrid_freqs > 0 else []
    return [_ptr(kp.flat), (ctypes.c_longlong * len(kp.offsets))(*kp.offsets),
            (ctypes.c_int * len(cfg.plane_res))(*cfg.plane_res),
            len(cfg.plane_res), cfg.plane_features, cfg.line_res,
            cfg.line_features, int(cfg.time_res > 0),
            float(2.0 * cfg.aabb_scale),
            (ctypes.c_float * max(1, len(bands)))(*[float(b) for b in bands]),
            len(bands)]


KP_C_ARGTYPES = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                  ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int])


def _launch(kp: PackedKPlanes, pts: torch.Tensor, ep_pad: int) -> torch.Tensor:
    """Launch the encode-only K3 kernel on the current stream."""
    check_kernel_shapes(kp, ep_pad)
    if ep_pad % 8:
        raise ValueError("fused_kplanes_encode: ep_pad must be a multiple of 8")
    p = pts.to(torch.float32).contiguous()
    if p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"fused_kplanes_encode: points must be (Q, 3), got "
                         f"{tuple(p.shape)}")
    if p.device.type != "cuda" or kp.flat.device != p.device:
        raise ValueError("fused_kplanes_encode: all tensors must be on one "
                         "CUDA device")
    Q = p.shape[0]
    out = torch.empty((Q, ep_pad), dtype=torch.bfloat16, device=p.device)
    lib = cuda_build.load("kplanes_encode")
    fn = lib.nerf_kplanes_encode
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + KP_C_ARGTYPES
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = fn(_ptr(p), Q, *kp_c_args(kp), ep_pad, _ptr(out),
             ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "kplanes_encode kernel launch")
    fused_kplanes_encode.launches += 1
    return out


def fused_kplanes_encode(kp: PackedKPlanes, pts: torch.Tensor, ep_pad: int, *,
                         device=None) -> torch.Tensor:
    """The k-planes encode of K2 on its own: (Q, 3) world points (already
    contracted, if the model contracts) → (Q, ep_pad) bf16 rows.

    Runs on ``cuda`` (the K3 kernel) unless ``device="cpu"`` (the plain
    version); the packed tables must already be on that device.
    """
    dev = resolve_device(device)
    if kp.flat.device.type != dev.type:
        raise ValueError(f"tables are on {kp.flat.device}, asked to run on {dev}")
    pts = pts.to(dev)
    if dev.type == "cpu":
        return kplanes_encode_plain(kp, pts, ep_pad)
    return _launch(kp, pts, ep_pad)


fused_kplanes_encode.launches = 0
