"""The port's mip-NeRF integrated positional encoding (``core/encoding.py``)
against the JAX package's functions on the CPU, and K4's closed-form
contraction pushforward (``ops/fused_raymarch.py``) against the port's
``jacfwd`` one.

Tolerances: rtol 1e-5, atol 1e-6 against JAX (fp32 on both sides; the
operation order is JAX's, so only libm ulps differ); the zero-variance IPE
equals the point encoding bit for bit; closed form against ``jacfwd`` 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core import encoding as je
from nerf_sandbox_tpu_torch.core import encoding as te
from nerf_sandbox_tpu_torch.ops.fused_raymarch import (
    contract_gaussian_closed_form, ipe_gaussians)

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0, b=6, n=9):
    """Rays from inside the unit ball out to radius ~7 (both branches of the
    contraction), sorted z, cone radii 5e-4..3e-2."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.05, 6.0, (b, n)), axis=-1).astype(np.float32)
    radii = rng.uniform(5e-4, 3e-2, (b,)).astype(np.float32)
    return o, d, z, radii


def _moments(o, d, z, radii, lib):
    lo, hi = lib.z_to_intervals(z)
    t_mean, t_var, r_var = lib.conical_frustum_moments(lo, hi, radii.reshape(-1, 1))
    mean, var = lib.lift_gaussian_diag(d, t_mean, t_var, r_var, o)
    return t_mean, t_var, r_var, mean, var


def _run(name, lib, arr):
    """One encoding function of ``lib`` (JAX or port) on the shared inputs;
    ``arr`` turns a numpy array into that library's array type."""
    o, d, z, radii = (arr(x) for x in _inputs())
    bands = arr(te.make_frequency_bands(10))
    if name == "z_to_intervals":
        return lib.z_to_intervals(z)
    if name == "conical_frustum_moments":
        lo, hi = lib.z_to_intervals(z)
        return lib.conical_frustum_moments(lo, hi, radii.reshape(-1, 1))
    if name == "lift_gaussian_diag":
        return _moments(o, d, z, radii, lib)[3:]
    t_mean, t_var, r_var, mean, var = _moments(o, d, z, radii, lib)
    if name == "integrated_positional_encoding":
        return (lib.integrated_positional_encoding(mean, var, bands, True),
                lib.integrated_positional_encoding(mean, var, bands, False))
    if name == "contract_gaussian":
        return lib.contract_gaussian(mean, d, t_var, r_var)
    assert name == "pixel_cone_radii"
    return (lib.pixel_cone_radii(arr(np.array(1111.1, np.float32)), 1.0 + radii),
            lib.pixel_cone_radii(arr(np.array(40.0, np.float32)),
                                 (1.0 + radii).reshape(-1, 1)))


FUNCS = ("z_to_intervals", "conical_frustum_moments", "lift_gaussian_diag",
         "integrated_positional_encoding", "contract_gaussian", "pixel_cone_radii")


@pytest.mark.parametrize("name", FUNCS)
def test_encoding_function_matches_jax(name):
    want = _run(name, je, jnp.asarray)
    got = _run(name, te, torch.from_numpy)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_contract_gaussian_straddles_the_unit_ball():
    """The inputs above put samples on both sides of |x| = 1, so both of
    the warp's branches (J = I inside) are held against JAX."""
    o, d, z, radii = (torch.from_numpy(x) for x in _inputs())
    mean = _moments(o, d, z, radii, te)[3]
    n = torch.linalg.vector_norm(mean, dim=-1)
    assert (n < 1.0).sum() >= 5 and (n > 2.0).sum() >= 5


@pytest.mark.parametrize("include_input", [True, False])
def test_ipe_at_zero_variance_is_the_point_encoding(include_input):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-2, 2, (32, 3)).astype(np.float32))
    bands = te.make_frequency_bands(10)
    pe = te.positional_encoding(x, bands, include_input=include_input)
    ipe = te.integrated_positional_encoding(x, torch.zeros_like(x), bands,
                                            include_input=include_input)
    assert torch.equal(ipe, pe)


def test_closed_form_pushforward_matches_jacfwd():
    """K4's plain version pushes the Gaussian through the contraction with
    the closed-form Jacobian; the port's ``contract_gaussian`` differentiates
    ``scene_contract`` with ``jacfwd``. Both must give the same Gaussian:
    means within 1e-5, variances (1e-8 to 2e-2 here) within 1e-5 relative."""
    o, d, z, radii = (torch.from_numpy(x) for x in _inputs(seed=3, b=16, n=24))
    _, t_var, r_var, mean, _ = _moments(o, d, z, radii, te)
    want = te.contract_gaussian(mean, d, t_var, r_var)
    for got in (contract_gaussian_closed_form(mean, d, t_var, r_var),
                ipe_gaussians(o, d, z, radii, True)):
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-5,
                                   atol=1e-12)
