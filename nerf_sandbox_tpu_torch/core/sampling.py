"""Ray-sample generation: stratified coarse samples + inverse-CDF fine samples.

Port of ``nerf_sandbox_tpu/core/sampling.py`` (reference
``nerf_sandbox/source/utils/sampling_utils.py:6-64`` and
``trainer.py:901-908``). Random draws come from an explicit
``torch.Generator`` or are injected as a tensor ``u``, so tests can hand the
same numbers to the JAX function.

``sample_pdf`` uses ``torch.searchsorted(right=True)`` and real gathers: the
JAX package's one-hot einsum formulation exists only because TPU gathers
are slow.

Fine-sample placement is sensitive to rounding: a z moved by a few ulps
moves the top encode band (2^9) by ~1e-3 rad. So the PDF's normaliser and
CDF are summed strictly left to right (the order of the JAX package's CPU
reductions, and the same on every device, unlike ``torch.cumsum``), and
``linspace(0, 1, n)`` is ``i * (1/(n-1))`` with an exact endpoint, as in
``jnp.linspace`` (``torch.linspace`` differs by an ulp).
"""

from __future__ import annotations

import torch


def linspace01(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``linspace(0, 1, n)`` rounded as ``jnp.linspace`` rounds it."""
    t = torch.arange(n, dtype=dtype, device=device)
    if n > 1:
        t = t * (1.0 / (n - 1))
        t[-1] = 1.0
    return t


def cumsum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along the last axis, one add per entry in
    order (a deterministic, device-independent summation order)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def stratified_samples(near, far, n_samples: int, dtype=torch.float32,
                       lindisp: bool = False, device=None) -> torch.Tensor:
    """Uniform z template over [near, far], shape (n_samples,)
    (``near*(1-t) + far*t``, trainer.py:901-902); ``lindisp`` spaces the
    samples uniformly in disparity."""
    t = linspace01(n_samples, dtype=dtype, device=device)
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    return near * (1.0 - t) + far * t


def perturb_z_samples(z: torch.Tensor, *, generator: torch.Generator | None = None,
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Jitter each sample uniformly within its stratified bin
    (trainer.py:904-907). ``u`` (same shape as ``z``) overrides the draw."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    lower = torch.cat([z[..., :1], mids], dim=-1)
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    if u is None:
        if generator is None:
            raise ValueError("perturb_z_samples: pass a generator or u")
        u = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                       device=generator.device)
    return lower + (upper - lower) * u.to(z.device, z.dtype)


def _mids_to_edges(mids: torch.Tensor) -> torch.Tensor:
    """Expand M midpoints to M+1 edges (sampling_utils.py:24-33)."""
    M = mids.shape[-1]
    if M == 1:
        d = torch.full_like(mids, 1e-3)
        return torch.cat([mids - 0.5 * d, mids + 0.5 * d], dim=-1)
    lo = mids[..., :1] - 0.5 * (mids[..., 1:2] - mids[..., :1])
    hi = mids[..., -1:] + 0.5 * (mids[..., -1:] - mids[..., -2:-1])
    inter = 0.5 * (mids[..., 1:] + mids[..., :-1])
    return torch.cat([lo, inter, hi], dim=-1)


def sample_pdf(
    bins: torch.Tensor,          # (B, M) midpoints OR (B, M+1) edges
    weights: torch.Tensor,       # (B, M)
    n_samples: int,
    *,
    generator: torch.Generator | None = None,
    deterministic: bool = False,
    u: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hierarchical sampling from a piecewise-constant PDF → (B, n_samples).

    ``u`` may be supplied explicitly; otherwise deterministic → inclusive
    linspace(0,1), stochastic → uniform draws from ``generator``.
    """
    B, M = weights.shape
    if bins.shape[-1] == M + 1:
        edges = bins
    elif bins.shape[-1] == M:
        edges = _mids_to_edges(bins)
    else:
        raise ValueError(f"Incompatible shapes: bins={tuple(bins.shape)}, "
                         f"weights={tuple(weights.shape)}")

    w = torch.clamp(weights + 1e-5, min=0.0)
    pdf = w / cumsum_left_to_right(w)[..., -1:]
    cdf = cumsum_left_to_right(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)   # (B, M+1)

    if u is None:
        if deterministic:
            u = linspace01(n_samples, dtype=cdf.dtype,
                           device=cdf.device).expand(B, n_samples)
        else:
            if generator is None:
                raise ValueError("sample_pdf: generator required when not "
                                 "deterministic")
            u = torch.rand((B, n_samples), generator=generator,
                           dtype=cdf.dtype, device=generator.device)
    u = u.to(cdf.device, cdf.dtype).expand(B, n_samples).contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, M)
    above = torch.clamp(inds, 1, M)

    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bin_lo = torch.gather(edges, -1, below)
    bin_hi = torch.gather(edges, -1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)


def merge_z_samples(z_coarse: torch.Tensor, z_fine: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse+fine samples (trainer.py:981)."""
    return torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values


def resample_midpoints(z: torch.Tensor, w: torch.Tensor, n: int, *,
                       generator: torch.Generator | None = None,
                       deterministic: bool = False,
                       u: torch.Tensor | None = None) -> torch.Tensor:
    """Fine z's from a coarse pass's per-sample weights (trainer.py:926-934):
    bins are the z midpoints, bin weights the averaged interval weights,
    detached, +1e-5 floor. ``u`` (B, n) overrides ``sample_pdf``'s draws.
    The proposal-mode ``power``/``explore_floor`` knobs of the JAX function
    are not ported (ROADMAP P7 item 4)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    wb = (0.5 * (w[..., 1:] + w[..., :-1])).detach() + 1e-5
    return sample_pdf(mids, wb, n, generator=generator,
                      deterministic=deterministic, u=u)


def distortion_loss(z: torch.Tensor, w: torch.Tensor, near, far,
                    lindisp: bool = False) -> torch.Tensor:
    """mip-NeRF 360's distortion loss (Barron et al. 2022, §4), JAX
    ``core/sampling.py:distortion_loss``:
    ``L = Σ_ij w_i w_j |u_i − u_j| + (1/3) Σ_i w_i² Δ_i`` per ray, averaged,
    in the sampler's normalised s-space (linear in z, or in disparity under
    ``lindisp``), by prefix sums over the sorted samples:
    ``Σ_ij w_i w_j |u_i − u_j| = 2 Σ_i w_i (u_i W_{<i} − S_{<i})``. ``z``
    (B, N) sorted samples, ``w`` (B, N) their weights (the gradient flows
    into ``w``)."""
    if lindisp:
        g, gn, gf = 1.0 / torch.clamp(z, min=1e-9), 1.0 / near, 1.0 / far
    else:
        g, gn, gf = z, near, far
    s = (g - gn) / (gf - gn)                                   # (B, N) in [0, 1]
    mids = 0.5 * (s[..., 1:] + s[..., :-1])
    e = torch.cat([s[..., :1], mids, s[..., -1:]], dim=-1)    # (B, N+1)
    u = 0.5 * (e[..., 1:] + e[..., :-1])                       # interval mids
    delta = e[..., 1:] - e[..., :-1]                           # interval sizes
    w_cum = torch.cumsum(w, dim=-1) - w                        # W_{<i}
    wu_cum = torch.cumsum(w * u, dim=-1) - w * u               # S_{<i}
    inter = 2.0 * torch.sum(w * (u * w_cum - wu_cum), dim=-1)
    intra = torch.sum(w * w * delta, dim=-1) / 3.0
    return torch.mean(inter + intra)
