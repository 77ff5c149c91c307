"""K-Planes factorised position encoder (static, 4-D and hybrid).

Port of ``nerf_sandbox_tpu/models/kplanes.py`` (Fridovich-Keil et al., CVPR
2023). Each scale holds three feature planes (xy, xz, yz) of shape (R, R, F);
a point's feature at that scale is the Hadamard product of its three bilinear
plane lookups. A CP triple of 1-D lines (line_res, Fl) adds fine axis-aligned
detail. 4-D models (``time_res > 0``) add space-time planes (xt, yt, zt) of
shape (R, time_res, F) per scale and a time line, all multiplied in. With
``hybrid_freqs > 0`` a parameter-free frequency encoding of the box-normalised
coordinates is appended: ``[s0 F, s1 F, ..., line Fl, hybrid 3+6L]``.

:func:`kplanes_encode` has the semantics of the JAX XLA path: hat-weight
matrices and tables cast to ``compute_dtype``, two matrix contractions per
plane, chunked over points. The fused eval kernel's own encode, with its
rounding points, is ``ops/kplanes_encode.py``.

Parameter names are the JAX names (``plane{s}_{xy,xz,yz}``,
``plane{s}_{xt,yt,zt}``, ``line_{x,y,z,t}``), so a JAX ``params["pos_grid"]``
dict converts name for name (``models/mlp.py:params_from_jax``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from nerf_sandbox_tpu_torch.core.encoding import (
    make_frequency_bands, positional_encoding)
from nerf_sandbox_tpu_torch.device import resolve_device

PLANES = (("xy", (0, 1)), ("xz", (0, 2)), ("yz", (1, 2)))
TIME_PLANES = (("xt", 0), ("yt", 1), ("zt", 2))


class KPlanesConfig(NamedTuple):
    plane_res: tuple = (64, 128)    # multiscale plane resolutions
    plane_features: int = 8         # F per scale
    line_res: int = 512             # CP line resolution
    line_features: int = 16         # CP components
    aabb_scale: float = 1.5         # world coords in [-aabb_scale, aabb_scale]^3
    chunk: int = 32768              # point chunk of kplanes_encode
    hybrid_freqs: int = 0           # >0: append [u, sin, cos] of u = 2*x01-1
    time_res: int = 0               # >0: 4-D (space-time planes + time line)
    # tensor parallelism over the feature axis: accepted for config parity
    # and ignored (one card, no model axis)
    shard_features: bool = False

    @property
    def out_dim(self) -> int:
        d = len(self.plane_res) * self.plane_features + self.line_features
        if self.hybrid_freqs > 0:
            d += 3 + 6 * self.hybrid_freqs          # include_input layout
        return d


def init_kplanes_params(cfg: KPlanesConfig, *,
                        generator: torch.Generator | None = None,
                        device=None) -> dict:
    """Seeded tables with the JAX distributions (kplanes.py:84-112): planes and
    lines N(1, 0.1), space-time planes and the time line exactly 1.0. Draws
    come from a CPU generator (seed 0 when none is given), in name order, so
    the tables do not depend on the device."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    F = cfg.plane_features

    def normal(shape):
        return 1.0 + 0.1 * torch.randn(shape, generator=g, dtype=torch.float32)

    params = {}
    for s, R in enumerate(cfg.plane_res):
        for name, _ in PLANES:
            params[f"plane{s}_{name}"] = normal((R, R, F))
    for name in ("x", "y", "z"):
        params[f"line_{name}"] = normal((cfg.line_res, cfg.line_features))
    if cfg.time_res > 0:
        for s, R in enumerate(cfg.plane_res):
            for name, _ in TIME_PLANES:
                params[f"plane{s}_{name}"] = torch.ones((R, cfg.time_res, F))
        params["line_t"] = torch.ones((cfg.time_res, cfg.line_features))
    return {k: v.to(dev) for k, v in params.items()}


class KPlanes(nn.Module):
    """The tables as parameters under their JAX names.
    ``forward(pts_world, compute_dtype=torch.bfloat16, t01=None)`` →
    (Q, out_dim) fp32."""

    def __init__(self, cfg: KPlanesConfig, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        for name, t in init_kplanes_params(cfg, generator=generator,
                                           device=device).items():
            self.register_parameter(name, nn.Parameter(t))

    def tables(self) -> dict:
        return dict(self.named_parameters())

    def forward(self, pts_world: torch.Tensor,
                compute_dtype: torch.dtype | None = torch.bfloat16,
                t01: torch.Tensor | None = None) -> torch.Tensor:
        return kplanes_encode(self.tables(), pts_world, self.cfg,
                              compute_dtype=compute_dtype, t01=t01)


def _tables(params) -> dict:
    return params.tables() if isinstance(params, KPlanes) else params


def _interp_weights(u01: torch.Tensor, R: int) -> torch.Tensor:
    """(Q,) coords in [0, 1] → (Q, R) hat rows relu(1 - |u(R-1) - i|): 1-frac
    at floor(u(R-1)), frac at the next node (kplanes.py:175-185)."""
    u = u01 * (R - 1)
    i = torch.arange(R, dtype=u01.dtype, device=u01.device)
    return torch.clamp(1.0 - torch.abs(u[:, None] - i[None, :]), min=0.0)


def _row_dot(w: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """einsum("qj,qjf->qf") in ``A``'s dtype: products and sums in fp32, one
    rounding (a dot with fp32 accumulation), as a fused multiply-sum rather
    than Q tiny batched products."""
    return (w.float()[:, :, None] * A.float()).sum(dim=1).to(A.dtype)


def _encode_chunk(params: dict, x01: torch.Tensor, cfg: KPlanesConfig,
                  compute_dtype: torch.dtype,
                  t01: torch.Tensor | None = None) -> torch.Tensor:
    """(Qc, 3) normalised coords [+ (Qc,) times] → (Qc, grid dims) fp32, with
    the JAX XLA path's casts (kplanes.py:188-243)."""
    cd, F = compute_dtype, cfg.plane_features
    feats = []
    wt = None
    if cfg.time_res > 0:
        wt = _interp_weights(t01, cfg.time_res).to(cd)
    for s, R in enumerate(cfg.plane_res):
        W = [_interp_weights(x01[:, d], R).to(cd) for d in range(3)]
        prod = None
        for name, (da, db) in PLANES:
            P = params[f"plane{s}_{name}"].to(cd)                  # (R, R, F)
            A = (W[da] @ P.reshape(R, -1)).reshape(-1, R, F)       # (Qc, R, F)
            f = _row_dot(W[db], A)
            prod = f if prod is None else prod * f
        if wt is not None:
            for name, da in TIME_PLANES:
                P = params[f"plane{s}_{name}"].to(cd)              # (R, T, F)
                A = (W[da] @ P.reshape(R, -1)).reshape(-1, cfg.time_res, F)
                prod = prod * _row_dot(wt, A)
        feats.append(prod)
    lw = [_interp_weights(x01[:, d], cfg.line_res).to(cd) for d in range(3)]
    line = ((lw[0] @ params["line_x"].to(cd)) * (lw[1] @ params["line_y"].to(cd))
            * (lw[2] @ params["line_z"].to(cd)))
    if wt is not None:
        line = line * (wt @ params["line_t"].to(cd))
    feats.append(line)
    return torch.cat(feats, dim=-1).float()


def kplanes_encode(params, pts_world: torch.Tensor, cfg: KPlanesConfig,
                   compute_dtype: torch.dtype | None = torch.bfloat16,
                   t01: torch.Tensor | None = None) -> torch.Tensor:
    """World points (Q, 3) [+ times (Q,) in [0, 1]] → (Q, out_dim) fp32.

    ``params`` is a :class:`KPlanes` or a dict of its tables. Chunked over Q
    (``cfg.chunk`` points), so the (chunk, R, F) intermediate bounds memory.
    """
    params = _tables(params)
    cd = torch.float32 if compute_dtype is None else compute_dtype
    Q = pts_world.shape[0]
    x01 = torch.clamp(pts_world / (2.0 * cfg.aabb_scale) + 0.5, 0.0, 1.0)
    if cfg.time_res > 0:
        if t01 is None:
            raise ValueError("KPlanesConfig.time_res > 0 needs per-point times")
        t01 = torch.clamp(t01.reshape(Q).to(x01), 0.0, 1.0)
    step = max(1, int(cfg.chunk))
    chunks = [_encode_chunk(params, x01[i:i + step], cfg, cd,
                            None if t01 is None else t01[i:i + step])
              for i in range(0, Q, step)]
    grid_dim = len(cfg.plane_res) * cfg.plane_features + cfg.line_features
    feats = torch.cat(chunks) if chunks else x01.new_zeros((0, grid_dim))
    if cfg.hybrid_freqs > 0:
        bands = make_frequency_bands(cfg.hybrid_freqs)
        feats = torch.cat([feats, positional_encoding(
            (x01 * 2.0 - 1.0).float(), bands)], dim=-1)
    return feats


def resize_kplanes_params(params, cfg: KPlanesConfig, plane_res: tuple) -> tuple:
    """Bilinearly resample the plane tables to ``plane_res`` → (tables, cfg).

    P' = D P Dᵀ with D[j, :] the interp row at u = j/(R'-1), so a linear
    field is kept exactly; space-time planes resample their spatial axis only;
    lines keep their resolution (kplanes.py:115-150).
    """
    if len(plane_res) != len(cfg.plane_res):
        raise ValueError("plane_res must give one resolution per scale")
    params = _tables(params)
    new = dict(params)
    for s, (r_old, r_new) in enumerate(zip(cfg.plane_res, plane_res)):
        if r_new == r_old:
            continue
        P0 = params[f"plane{s}_xy"]
        D = _interp_weights(torch.linspace(0.0, 1.0, r_new, dtype=torch.float32,
                                           device=P0.device), r_old)
        for name, _ in PLANES:
            new[f"plane{s}_{name}"] = torch.einsum(
                "ai,bj,ijf->abf", D, D, params[f"plane{s}_{name}"])
        if cfg.time_res > 0:
            for name, _ in TIME_PLANES:
                new[f"plane{s}_{name}"] = torch.einsum(
                    "ai,itf->atf", D, params[f"plane{s}_{name}"])
    return new, cfg._replace(plane_res=tuple(plane_res))


def kplanes_tv(params) -> torch.Tensor:
    """Total variation of the tables (k-planes §3.2): mean squared difference
    of adjacent texels along both plane axes and along each line, averaged
    over tables (kplanes.py:153-172)."""
    tv, n = 0.0, 0
    for name, P in _tables(params).items():
        if name.startswith("plane"):
            tv = tv + torch.mean((P[1:] - P[:-1]) ** 2) \
                    + torch.mean((P[:, 1:] - P[:, :-1]) ** 2)
            n += 2
        elif name.startswith("line"):
            tv = tv + torch.mean((P[1:] - P[:-1]) ** 2)
            n += 1
    return tv / max(n, 1)
