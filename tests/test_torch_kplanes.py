"""The port's k-planes encoder (``models/kplanes.py``), scene contraction
(``core/encoding.py``) and K3's plain version (``ops/kplanes_encode.py``)
against the JAX package on the CPU, at the JAX tests' widths: planes (8, 16)
with F = 8 or 4, lines 32 x 8, aabb 2.0.

Tolerances: contraction 1e-6; hat weights exact; ``kplanes_encode`` 1e-5 in
fp32 and 2e-2 in bf16 (both sides round at the same casts, in other
summation orders); ``resize_kplanes_params`` and ``kplanes_tv`` 1e-5;
``params_from_jax`` and the checkpoint reader bit for bit; K3's plain version
against the Pallas kernel's own encode body (``_kp_encode_body`` on the
tables of ``_kp_pack_tables``, run outside ``pallas_call``) within one bf16
ulp, |Δ| <= 2^-7·max(1, |v|). The tables are N(1, 0.3) draws, different along
each axis, so a swapped axis or table gives a different field (checked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core import encoding as jenc
from nerf_sandbox_tpu.models import kplanes as jk
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.ops import fused_raymarch as jfr
from nerf_sandbox_tpu.train.checkpoints import save_checkpoint
from nerf_sandbox_tpu.train.step import TrainState
from nerf_sandbox_tpu_torch.core import encoding as tenc
from nerf_sandbox_tpu_torch.models import kplanes as tk
from nerf_sandbox_tpu_torch.models import mlp as tmlp
from nerf_sandbox_tpu_torch.ops import kplanes_encode as tke
from nerf_sandbox_tpu_torch.train import checkpoints as tckpt

MODES = {"static": dict(), "hybrid3": dict(hybrid_freqs=3),
         "4d": dict(time_res=6),
         # the edges of K3's work list (csrc/kplanes_encode.cuh): the 360
         # default of 6 bands, one and four scales, one plane feature beside
         # 12 line features (texel groups of 1 and 2), 4-D with hybrid bands
         "hybrid6": dict(hybrid_freqs=6),
         "one_scale": dict(plane_res=(8,), hybrid_freqs=2),
         "four_scales": dict(plane_res=(4, 8, 12, 16), hybrid_freqs=1),
         "f1_fl12": dict(plane_features=1, line_features=12, hybrid_freqs=3),
         "4d_hybrid6": dict(time_res=6, hybrid_freqs=6)}
# modes whose K3 rows are padded to 64 columns; the others to the first
# multiple of 8 that fits
EP64 = ("static", "hybrid3", "4d")


def _cfgs(F=4, **kw):
    cfg = dict(plane_res=(8, 16), plane_features=F, line_res=32, line_features=8,
               aabb_scale=2.0)
    cfg.update(kw)
    j = jk.KPlanesConfig(**cfg)
    return j, tk.KPlanesConfig(*j)


def _tables(jcfg, seed=0):
    """N(1, 0.3) tables (time planes included), the same for both sides."""
    rng = np.random.RandomState(seed)
    shapes = jk.init_kplanes_params(jax.random.PRNGKey(0), jcfg)
    return {k: (1.0 + 0.3 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in shapes.items()}


def _points(q=300, seed=1):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-2.3, 2.3, (q, 3)).astype(np.float32)   # some clip
    pts[:4] = [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0], [0, 0, 0], [2.0, -1.0, 0.5]]
    return pts


def _j(tabs):
    return {k: jnp.asarray(v) for k, v in tabs.items()}


def _t(tabs):
    return {k: torch.from_numpy(v) for k, v in tabs.items()}


def test_scene_contract_matches_jax():
    rng = np.random.RandomState(0)
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    radii = np.concatenate([rng.uniform(0, 1, 10), np.ones(10),
                            rng.uniform(1, 50, 19), [0.0]]).astype(np.float32)
    x = d * radii[:, None]
    for jf, tf, inp in ((jenc.scene_contract, tenc.scene_contract, x),
                        (jenc.scene_uncontract, tenc.scene_uncontract,
                         np.asarray(jenc.scene_contract(jnp.asarray(x))))):
        want = np.asarray(jf(jnp.asarray(inp)))
        got = tf(torch.from_numpy(np.array(inp))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    got = tenc.scene_contract(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got, axis=-1).max() < 2.0
    np.testing.assert_array_equal(got[:20], x[:20])        # the unit ball stays


def test_interp_weights_exact():
    for R in (2, 8, 16, 32):
        nodes = np.arange(R, dtype=np.float32) / (R - 1)
        u = np.concatenate([[0.0, 1.0], nodes,
                            np.random.RandomState(R).uniform(0, 1, 50)]
                           ).astype(np.float32)
        want = np.asarray(jk._interp_weights(jnp.asarray(u), R))
        got = tk._interp_weights(torch.from_numpy(u), R).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kplanes_encode_matches_jax(mode, dtype):
    jcfg, tcfg = _cfgs(chunk=128, **MODES[mode])
    tabs = _tables(jcfg)
    pts = _points()
    t01 = np.random.RandomState(2).uniform(0, 1, len(pts)).astype(np.float32)
    tt = jcfg.time_res > 0
    want = np.asarray(jk.kplanes_encode(
        _j(tabs), jnp.asarray(pts), jcfg, compute_dtype=jnp.dtype(dtype),
        t01=jnp.asarray(t01) if tt else None))
    got = tk.kplanes_encode(_t(tabs), torch.from_numpy(pts), tcfg,
                            compute_dtype=getattr(torch, dtype),
                            t01=torch.from_numpy(t01) if tt else None)
    assert got.dtype == torch.float32 and got.shape == (300, tcfg.out_dim)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    # the tables differ along each axis: a swapped plane moves the field
    swapped = dict(_t(tabs), plane0_xy=_t(tabs)["plane0_xy"].transpose(0, 1))
    moved = tk.kplanes_encode(swapped, torch.from_numpy(pts), tcfg,
                              compute_dtype=getattr(torch, dtype),
                              t01=torch.from_numpy(t01) if tt else None)
    assert float((moved - got).abs().max()) > 10 * tol


def test_resize_and_tv_match_jax():
    jcfg, tcfg = _cfgs(time_res=5)
    tabs = _tables(jcfg, seed=3)
    new_j, cfg_j = jk.resize_kplanes_params(_j(tabs), jcfg, (6, 8))
    new_t, cfg_t = tk.resize_kplanes_params(_t(tabs), tcfg, (6, 8))
    assert tuple(cfg_t) == tuple(cfg_j)
    assert set(new_t) == set(new_j)
    for k in new_j:
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tk.kplanes_tv(_t(tabs))),
                               float(jk.kplanes_tv(_j(tabs))), atol=1e-5)
    np.testing.assert_allclose(float(tk.kplanes_tv(new_t)),
                               float(jk.kplanes_tv(new_j)), atol=1e-5)


def test_seeded_init_distributions():
    """Full-width tables (planes (64, 128) x 8, lines 512 x 16): the same seed
    gives the same tables; planes and lines have the mean and std of JAX's
    N(1, 0.1) within 5%; the time tables are exactly 1."""
    tcfg = tk.KPlanesConfig(time_res=4)
    a = tk.KPlanes(tcfg, generator=torch.Generator().manual_seed(7), device="cpu")
    b = tk.KPlanes(tcfg, generator=torch.Generator().manual_seed(7), device="cpu")
    c = tk.KPlanes(tcfg, generator=torch.Generator().manual_seed(8), device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.plane1_xy, c.plane1_xy)
    jp = jk.init_kplanes_params(jax.random.PRNGKey(0), jk.KPlanesConfig(*tcfg))
    assert set(a.state_dict()) == set(jp)
    for k, v in a.state_dict().items():
        assert tuple(v.shape) == jp[k].shape, k
        if k == "line_t" or k.split("_")[-1] in ("xt", "yt", "zt"):
            assert torch.all(v == 1.0), k
            continue
        v, jv = v.numpy(), np.asarray(jp[k])
        for got, want in ((v.mean(), 1.0), (v.std(), 0.1),
                          (v.mean(), jv.mean()), (v.std(), jv.std())):
            assert abs(got - want) < 0.05 * want, k


def test_params_from_jax_pos_grid_bit_exact(tmp_path):
    """A JAX k-planes model (MLP + ``params["pos_grid"]``) converts array for
    array, loads into ``NeRFMLP(grid_cfg=...)``, and reads back from a JAX
    checkpoint the same."""
    jcfg, tcfg = _cfgs(F=8, hybrid_freqs=2)
    jm = jmlp.NeRFConfig(jcfg.out_dim, 27, n_layers=3, hidden_dim=32, skip_pos=1)
    params = jax.tree_util.tree_map(
        np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(1), jm))
    params["pos_grid"] = _tables(jcfg, seed=4)
    sd = tmlp.params_from_jax(params)
    for k, v in params["pos_grid"].items():
        assert sd[f"pos_grid.{k}"].dtype == torch.float32
        np.testing.assert_array_equal(sd[f"pos_grid.{k}"].numpy(), v, err_msg=k)
    m = tmlp.NeRFMLP(tmlp.NeRFConfig(*jm), grid_cfg=tcfg, device="cpu")
    m.load_state_dict(sd)
    assert isinstance(m.pos_grid, tk.KPlanes)
    np.testing.assert_array_equal(m.pos_grid.line_z.detach().numpy(),
                                  params["pos_grid"]["line_z"])
    assert tmlp.NeRFMLP(tmlp.NeRFConfig(63, 27), device="cpu").pos_grid is None
    with pytest.raises(NotImplementedError, match="P7 item 8"):
        tmlp.params_from_jax({**params, "pos_grid": np.zeros((16, 2))})

    state = TrainState(step=jnp.int32(7), params_c=params, params_f=params,
                       opt_state=None)
    path = save_checkpoint(tmp_path / "checkpoints", 7, state, {},
                           include_optim=False)
    sd_c, sd_f = tckpt.load_params_from_jax_ckpt(path)
    for got in (sd_c, sd_f):
        assert set(got) == set(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_plain_k3_matches_the_pallas_encode_body(mode):
    """K3's plain version (the CUDA kernel's twin) and its table packing
    against the TPU kernel's own encode body and packing, on the same
    points: one bf16 ulp."""
    jcfg, tcfg = _cfgs(F=8, **MODES[mode])
    tabs = _tables(jcfg, seed=5)
    pts = _points(seed=6)
    t = 0.37 if jcfg.time_res else None
    jtabs, meta = jfr._kp_pack_tables(_j(tabs), jcfg,
                                      t=None if t is None else jnp.float32(t))
    packed = tke.pack_kplanes(_t(tabs), tcfg, t=t)
    assert list(packed.views) == list(tke._table_shapes(tcfg))
    for jt, (name, view) in zip(jtabs, packed.views.items()):
        jt = np.asarray(jt.astype(jnp.float32))
        got = view.float().numpy()
        if name.startswith("plane"):
            jt = jt.transpose(1, 2, 0)            # TPU (F, R, R) -> (R, R, F)
        np.testing.assert_allclose(got, jt, rtol=2.0 ** -8, atol=0, err_msg=name)
    ep = 64 if mode in EP64 else -(-tcfg.out_dim // 8) * 8
    h = jcfg.hybrid_freqs
    if h:
        hb = np.asarray(jenc.make_frequency_bands(h), np.float32)
        consts = jfr._encode_constants(hb, True, 3 + 6 * h)
    else:
        consts = (np.zeros((3, 8), np.float32),) + (np.zeros((1, 8), np.float32),) * 3
    want = np.asarray(jfr._kp_encode_body(
        jnp.asarray(pts), jtabs, *map(jnp.asarray, consts), meta, ep
    ).astype(jnp.float32))
    got = tke.kplanes_encode_plain(packed, torch.from_numpy(pts), ep)
    assert got.dtype == torch.bfloat16 and got.shape == (300, ep)
    tke.check_kernel_shapes(packed, ep)
    got = got.float().numpy()
    assert np.all(got[:, packed.cfg.out_dim:] == 0.0)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.maximum(1.0, np.abs(want)))
    # the entry point takes the plain version for CPU tensors, no launch
    before = tke.fused_kplanes_encode.launches
    same = tke.fused_kplanes_encode(packed, torch.from_numpy(pts), ep,
                                    device="cpu")
    assert torch.equal(same.float(), torch.from_numpy(got))
    assert tke.fused_kplanes_encode.launches == before


def test_packed_tables_carry_their_c_arguments():
    """pack_kplanes builds the kernels' ctypes arguments once; the launches
    reuse them (the table pointer, offsets, resolutions and bands), and new
    ones describe a replaced buffer."""
    jcfg, tcfg = _cfgs(F=8, hybrid_freqs=3)
    packed = tke.pack_kplanes(_t(_tables(jcfg)), tcfg)
    args = tke.kp_c_args(packed)
    assert len(args) == len(tke.KP_C_ARGTYPES) == len(packed.c_args)
    assert all(a is b for a, b in zip(args, packed.c_args))
    assert args[0].value == packed.flat.data_ptr()
    assert list(args[1]) == list(packed.offsets)
    assert list(args[2]) == list(tcfg.plane_res) and args[3:8] == [2, 8, 32, 8, 0]
    assert list(args[9])[:3] == [1.0, 2.0, 4.0] and args[10] == 3
    moved = packed._replace(flat=packed.flat.clone())
    fresh = tke.kp_c_args(moved)
    assert fresh[0].value == moved.flat.data_ptr() != args[0].value
    assert list(fresh[1]) == list(packed.offsets) and fresh[3:8] == args[3:8]


def test_kernel_shape_checks():
    """Any plane and line feature width (the kernels read groups of 8, 4, 2
    or 1 features); rows must fit the padded width."""
    _, tcfg = _cfgs(F=4)
    packed = tke.pack_kplanes(_t(_tables(_cfgs(F=4)[0])), tcfg)
    tke.check_kernel_shapes(packed, 64)
    j6 = jk.KPlanesConfig(plane_res=(8, 16), plane_features=6, line_res=32,
                          line_features=12, aabb_scale=2.0)
    packed6 = tke.pack_kplanes(_t(_tables(j6)), tk.KPlanesConfig(*j6))
    tke.check_kernel_shapes(packed6, 64)
    with pytest.raises(ValueError, match="do not fit"):
        tke.check_kernel_shapes(packed6, 16)
    _, tcfg8 = _cfgs(F=8, hybrid_freqs=6)
    packed8 = tke.pack_kplanes(_t(_tables(_cfgs(F=8, hybrid_freqs=6)[0])), tcfg8)
    tke.check_kernel_shapes(packed8, 64)
    with pytest.raises(ValueError, match="do not fit"):
        tke.check_kernel_shapes(packed8, 32)
    with pytest.raises(ValueError, match="frame time"):
        tke.pack_kplanes(_t(_tables(_cfgs(time_res=3)[0])), _cfgs(time_res=3)[1])
