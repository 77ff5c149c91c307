"""Sinusoidal (frequency) positional encoding, mip-NeRF's integrated
positional encoding (IPE) and the mip-NeRF 360 contraction.

Port of the frequency, IPE and contraction parts of
``nerf_sandbox_tpu/core/encoding.py`` (reference
``nerf_sandbox/source/models/encoders.py:6-123``):
gamma(x) = [x?, sin(f_k x), cos(f_k x)] with the reference's feature order —
all sin blocks for every band first, then all cos blocks:
``[x?, sin(f0 x0..2), sin(f1 x0..2), ..., cos(f0 x0..2), ...]``. The IPE
(Barron et al. 2021, eq. 7 and 14) keeps that layout, with each sin/cos
column attenuated by its Gaussian's variance.

Arguments ``x * f`` are fp32 and sin/cos are the accurate library functions:
the top vanilla band is 2^9, so arguments reach thousands of radians.
"""

from __future__ import annotations

import numpy as np
import torch


def make_frequency_bands(num_freqs: int, *, log_spaced: bool = True,
                         min_freq_log2: int | None = None,
                         max_freq_log2: int | None = None,
                         use_two_pi: bool = False) -> np.ndarray:
    """Frequency bands, matching encoders.py:54-66 (+ 2*pi factor :91-92)."""
    if min_freq_log2 is None:
        min_freq_log2 = 0
    if max_freq_log2 is None:
        max_freq_log2 = num_freqs - 1
    if log_spaced:
        bands = 2.0 ** np.linspace(float(min_freq_log2), float(max_freq_log2),
                                   num=num_freqs, dtype=np.float64)
    else:
        bands = np.linspace(2.0 ** float(min_freq_log2),
                            2.0 ** float(max_freq_log2),
                            num=num_freqs, dtype=np.float64)
    if use_two_pi:
        bands = bands * (2.0 * np.pi)
    return bands.astype(np.float32)


def encoder_out_dim(input_dims: int, num_freqs: int,
                    include_input: bool = True) -> int:
    """out_dim = D·include_input + D·2F (encoders.py:71)."""
    return (input_dims if include_input else 0) + input_dims * num_freqs * 2


def positional_encoding(x: torch.Tensor, freq_bands,
                        include_input: bool = True) -> torch.Tensor:
    """Apply gamma(x). ``x``: (..., D); ``freq_bands``: (F,). → (..., out_dim)."""
    fb = torch.as_tensor(freq_bands, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * fb[:, None]                 # (..., F, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)   # (..., 2F, D)
    enc = enc.reshape(*x.shape[:-1], -1)               # (..., 2F*D)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def encode_dirs(vdirs: torch.Tensor, dir_bands, include_input: bool = True,
                dir_encoder: str = "freq") -> torch.Tensor:
    """View-direction encoder switch; only the reference ``freq`` gamma is
    ported."""
    if dir_encoder != "freq":
        raise NotImplementedError(
            f"dir_encoder={dir_encoder!r}: spherical harmonics are ROADMAP "
            "queue 1, P7 item 6 (SH dirs)")
    return positional_encoding(vdirs, dir_bands, include_input=include_input)


def scene_contract(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """mip-NeRF 360 scene contraction (Barron et al. 2022, eq. 10).

    contract(x) = x for ||x|| <= 1, else (2 - 1/||x||) * x/||x||: all of R^3
    lands in the radius-2 ball. Branchless, with the norm floored at ``eps``
    (JAX core/encoding.py:283-300).
    """
    n = torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)
    return torch.where(n <= 1.0, x, (2.0 - 1.0 / n) * (x / n))


def z_to_intervals(z: torch.Tensor):
    """Per-sample integration intervals of sorted samples ``z`` (..., N),
    N >= 2 → (lower, upper): interior edges are the midpoints between
    neighbours, the end intervals mirror their neighbour edge (JAX
    core/encoding.py:151-164)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    lower = torch.cat([2.0 * z[..., :1] - mids[..., :1], mids], dim=-1)
    upper = torch.cat([mids, 2.0 * z[..., -1:] - mids[..., -1:]], dim=-1)
    return lower, upper


def conical_frustum_moments(t0: torch.Tensor, t1: torch.Tensor,
                            base_radius: torch.Tensor):
    """(t_mean, t_var, r_var) of a uniform conical frustum over [t0, t1] on
    a cone of radius ``base_radius * t`` (mip-NeRF eq. 7, the stable form;
    JAX core/encoding.py:167-187, same operation order)."""
    mu = (t0 + t1) / 2.0
    hw = (t1 - t0) / 2.0
    denom = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + (2.0 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * (
        (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / denom ** 2)
    r_var = base_radius ** 2 * (
        mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
        - (4.0 / 15.0) * hw ** 4 / denom)
    return t_mean, t_var, r_var


def lift_gaussian_diag(d_unit: torch.Tensor, t_mean: torch.Tensor,
                       t_var: torch.Tensor, r_var: torch.Tensor,
                       rays_o: torch.Tensor):
    """Axial/radial frustum moments → world-space diagonal Gaussians:
    ``d_unit``/``rays_o`` (B, 3), moments (B, N) → (mean, var) (B, N, 3)
    (JAX core/encoding.py:190-203)."""
    mean = rays_o[..., None, :] + d_unit[..., None, :] * t_mean[..., None]
    d2 = d_unit ** 2
    var = (t_var[..., None] * d2[..., None, :]
           + r_var[..., None] * (1.0 - d2[..., None, :]))
    return mean, var


def integrated_positional_encoding(mean: torch.Tensor, var_diag: torch.Tensor,
                                   freq_bands,
                                   include_input: bool = True) -> torch.Tensor:
    """IPE (mip-NeRF eq. 14): E[sin(f x)] = sin(f mu) exp(-f² σ²/2) for a
    diagonal Gaussian, in :func:`positional_encoding`'s column layout with
    the mean prepended; zero variance gives the point encoding bit for bit
    (JAX core/encoding.py:206-229)."""
    fb = torch.as_tensor(freq_bands, dtype=mean.dtype, device=mean.device)
    xb = mean[..., None, :] * fb[:, None]                      # (..., F, D)
    att = torch.exp(-0.5 * var_diag[..., None, :] * (fb ** 2)[:, None])
    enc = torch.cat([torch.sin(xb) * att, torch.cos(xb) * att], dim=-2)
    enc = enc.reshape(*mean.shape[:-1], -1)
    if include_input:
        enc = torch.cat([mean, enc], dim=-1)
    return enc


def contract_gaussian(mean: torch.Tensor, d_unit: torch.Tensor,
                      t_var: torch.Tensor, r_var: torch.Tensor):
    """Push a frustum Gaussian through :func:`scene_contract`, linearised
    (mip-NeRF 360 §3.3), keeping its rank-one axial/radial structure:
    diag(J Σ Jᵀ) = t_var·(Jd)² + r_var·max(rowsum(J∘J) − (Jd)², 0), J by
    forward-mode autodiff per point (JAX core/encoding.py:232-266).

    ``mean`` (B, N, 3), ``d_unit`` (B, 3), ``t_var``/``r_var`` (B, N) →
    (contracted mean, var_diag), each (B, N, 3).
    """
    shape = mean.shape
    m = mean.reshape(-1, 3)
    d = d_unit[..., None, :].expand(shape).reshape(-1, 3)
    J = torch.func.vmap(torch.func.jacfwd(scene_contract))(m)   # (Q, 3, 3)
    Jd = torch.einsum("qij,qj->qi", J, d)
    row2 = torch.sum(J * J, dim=-1)
    tv = t_var.reshape(-1, 1)
    rv = r_var.reshape(-1, 1)
    new_v = tv * Jd ** 2 + rv * torch.clamp(row2 - Jd ** 2, min=0.0)
    return scene_contract(m).reshape(shape), new_v.reshape(shape)


def pixel_cone_radii(fx, d_norm: torch.Tensor) -> torch.Tensor:
    """Per-ray base radius of the pixel's cone in the unit-direction
    parameterisation, 2/sqrt(12)/fx / ||d|| (JAX core/encoding.py:269-280);
    ``d_norm`` (..., 1) or (...,)."""
    r = (2.0 / torch.sqrt(torch.tensor(12.0, device=d_norm.device))) / fx
    return r / torch.clamp(d_norm, min=1e-9)


def scene_uncontract(c: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Inverse of :func:`scene_contract` on the open radius-2 ball; inputs at
    ||c|| >= 2 are clamped just inside the shell (JAX core/encoding.py:303-320).
    """
    n = torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=eps)
    n_c = torch.clamp(n, max=2.0 - eps)
    r = 1.0 / (2.0 - n_c)
    return torch.where(n <= 1.0, c, (c / n) * r)


def vanilla_encoders():
    """(pos_bands, dir_bands) for official NeRF defaults (encoders.py:108-123).

    Positions: L=10 → 63 out dims. Viewdirs: L=4 → 27 out dims.
    """
    return make_frequency_bands(10), make_frequency_bands(4)
