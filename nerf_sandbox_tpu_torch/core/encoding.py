"""Sinusoidal (frequency) positional encoding and the mip-NeRF 360 contraction.

Port of the frequency and contraction parts of
``nerf_sandbox_tpu/core/encoding.py`` (reference
``nerf_sandbox/source/models/encoders.py:6-123``):
gamma(x) = [x?, sin(f_k x), cos(f_k x)] with the reference's feature order —
all sin blocks for every band first, then all cos blocks:
``[x?, sin(f0 x0..2), sin(f1 x0..2), ..., cos(f0 x0..2), ...]``.

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
