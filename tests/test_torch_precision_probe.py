"""K5's plain versions (``ops/precision_probe.py``) against the TPU probe's
own Pallas kernel (``scripts/probe_mosaic_precision.py:_dot_kernel``, loaded
by path, run in interpret mode at HIGHEST) and against independent
roundings, on the CPU. The CUDA kernel is held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: the fp32 mode against the Pallas HIGHEST dot within
K·2⁻²³·Σ|a||b| (two fp32 accumulations of K products); the bf16 mode equal
to the fp64 product of bf16-rounded inputs; tf32 rounding exact on
constructed ties; bf16x3 within 2⁻¹⁵·Σ|a||b| of the fp64 oracle (the JAX
``_dotx`` bound test's).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_sandbox_tpu_torch.ops import precision_probe as pp

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "probe_mosaic_precision.py"
SHAPES = {name: (a, b) for name, a, b in pp.probe_inputs()}


def _tpu_probe():
    spec = importlib.util.spec_from_file_location("probe_mosaic_precision", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scale(a, b):
    return np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))


@pytest.mark.parametrize("name", SHAPES)
def test_fp32_mode_matches_the_pallas_probe_at_highest(name):
    a, b = SHAPES[name]
    mod = _tpu_probe()
    kernel = functools.partial(mod._dot_kernel, prec=jax.lax.Precision.HIGHEST)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((a.shape[0], b.shape[1]), jnp.float32),
        interpret=True)(jnp.asarray(a), jnp.asarray(b)), np.float64)
    got = pp.precision_dot_plain(torch.from_numpy(a), torch.from_numpy(b), "fp32")
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    tol = a.shape[1] * 2.0 ** -23 * _scale(a, b)
    assert np.all(np.abs(got.numpy() - want) <= tol)


def test_probe_inputs_are_the_scripts():
    """The port builds the probe's inputs as the TPU script's ``main`` does."""
    made = []
    mod = _tpu_probe()
    mod.run = lambda name, a, b: made.append((name, a, b))
    mod.main()
    assert [m[0] for m in made] == list(SHAPES)
    for name, a, b in made:
        np.testing.assert_array_equal(a, SHAPES[name][0])
        np.testing.assert_array_equal(b, SHAPES[name][1])


@pytest.mark.parametrize("name", SHAPES)
def test_bf16_mode_is_the_product_of_bf16_inputs(name):
    a, b = SHAPES[name]
    ra = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float64)
    rb = np.asarray(jnp.asarray(b, jnp.bfloat16), np.float64)
    got = pp.precision_dot_plain(torch.from_numpy(a), torch.from_numpy(b), "bf16")
    np.testing.assert_array_equal(got.numpy(), ra @ rb)


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 - 2 ** -23, float("inf"), float("-inf"), 0.0])
    want = [1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0,
            float("inf"), float("-inf"), 0.0]
    assert pp.round_tf32(x).tolist() == want
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 1e3)
    r = pp.round_tf32(v)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert float(((r - v).abs() / v.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("name", SHAPES)
def test_bf16x3_is_three_limb_products(name):
    a, b = SHAPES[name]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = pp.precision_dot_plain(ta, tb, "bf16x3").numpy()
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.all(np.abs(got - exact) <= 2.0 ** -15 * _scale(a, b))
    one_pass = pp.precision_dot_plain(ta, tb, "bf16").numpy()
    assert np.abs(got - exact).max() < np.abs(one_pass - exact).max()


def test_wrapper_on_the_cpu_and_bad_inputs():
    a, b = SHAPES["tri cumsum (tri@logT)"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = pp.precision_dot.launches
    for mode in pp.MODES:
        out = pp.precision_dot(ta, tb, mode, device="cpu")
        assert out.dtype == torch.float32 and out.shape == (16, 128)
        assert torch.equal(out, pp.precision_dot_plain(ta, tb, mode).float())
    assert pp.precision_dot.launches == before
    with pytest.raises(ValueError, match="mode"):
        pp.precision_dot(ta, tb, "fp16", device="cpu")
    with pytest.raises(ValueError, match="cannot multiply"):
        pp.precision_dot(tb, tb, "fp32", device="cpu")
    rows = pp.run_probe("cpu")
    assert len(rows) == len(SHAPES) * len(pp.MODES)
    err = {(r["shape"], r["mode"]): r["max_abs"] for r in rows}
    for name in SHAPES:   # each mode is at least as exact as the one before
        assert (err[name, "bf16"] >= err[name, "tf32"] >= err[name, "bf16x3"]
                >= err[name, "fp32"])
