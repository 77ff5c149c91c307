"""K1's plain PyTorch version (``ops/fused_mlp.py``) against the JAX fused MLP
(Pallas, interpret mode) and ``nerf_apply`` in bf16, on the CPU. The CUDA
kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 0.05 against both JAX functions (the JAX fused-MLP test's bf16
bound); 1e-5 for padding independence (rows never mix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.ops import fused_mlp as jfm
from nerf_sandbox_tpu_torch.models import mlp as tmlp
from nerf_sandbox_tpu_torch.ops import fused_mlp as tfm

JCFG = jmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                       hidden_dim=256, skip_pos=4)
TCFG = tmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                       hidden_dim=256, skip_pos=4)


def _setup(seed=0, q=300):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), JCFG)
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    m.load_state_dict(tmlp.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(seed)
    ep = (rng.normal(size=(q, 63)) * 0.5).astype(np.float32)
    ed = (rng.normal(size=(q, 27)) * 0.5).astype(np.float32)
    return params, m, ep, ed


def test_plain_matches_jax_fused_and_nerf_apply_bf16():
    params, m, ep, ed = _setup()
    got = tfm.fused_nerf_apply(m, torch.from_numpy(ep), torch.from_numpy(ed),
                               device="cpu").numpy()
    assert got.shape == (300, 4) and got.dtype == np.float32
    fused = np.asarray(jfm.fused_nerf_apply(params, JCFG, jnp.asarray(ep),
                                            jnp.asarray(ed), interpret=True))
    bf16 = np.asarray(jmlp.nerf_apply(params, JCFG, jnp.asarray(ep),
                                      jnp.asarray(ed),
                                      compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got, fused, atol=0.05)
    np.testing.assert_allclose(got, bf16, atol=0.05)
    assert np.std(got) > 1e-3


def test_plain_padding_independence():
    _, m, ep, ed = _setup(seed=1, q=2049)
    packed = tfm.pack_nerf_params(m)
    full = tfm.fused_nerf_apply_plain(packed, torch.from_numpy(ep),
                                      torch.from_numpy(ed))
    head = tfm.fused_nerf_apply_plain(packed, torch.from_numpy(ep[:100]),
                                      torch.from_numpy(ed[:100]))
    np.testing.assert_allclose(full[:100].numpy(), head.numpy(), atol=1e-5)
    empty = tfm.fused_nerf_apply_plain(packed, torch.zeros(0, 63),
                                       torch.zeros(0, 27))
    assert empty.shape == (0, 4)


def test_pack_layout_matches_jax_pack():
    """The port's packing holds the same bf16 values as the JAX kernel's
    (``pack_nerf_params``), without the TPU's 128-lane output padding."""
    params, m, _, _ = _setup(seed=2)
    v = tfm.pack_nerf_params(m).views
    j = jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)),
                               jfm.pack_nerf_params(params, JCFG))

    def f(x):
        return x.float().numpy()

    for name in ("w0", "w_mid", "b_mid", "wskip_h", "wskip_e", "wc1"):
        np.testing.assert_array_equal(f(v[name]), j[name], err_msg=name)
    for name in ("b0", "bskip", "bc1"):
        np.testing.assert_array_equal(f(v[name]), j[name][0], err_msg=name)
    np.testing.assert_array_equal(f(v["w_feat"]), j["w_sf"][:, :256])
    np.testing.assert_array_equal(f(v["w_sig"]), j["w_sf"][:, 256])
    np.testing.assert_array_equal(f(v["b_feat"]), j["b_sf"][0, :256])
    np.testing.assert_array_equal(f(v["b_sig"]), j["b_sf"][0, 256:257])
    np.testing.assert_array_equal(f(v["wc2t"]), j["wc2"][:, :3].T)
    np.testing.assert_array_equal(f(v["bc2"]), j["bc2"][0, :3])
    flat = tfm.pack_nerf_params(m)
    assert flat.flat.dtype == torch.bfloat16
    assert all(o % 64 == 0 for o in flat.offsets)     # 128-byte aligned arrays


def test_fusable_guard():
    for cfg, want in ((TCFG, True), (tmlp.NeRFConfig(63, 27, hidden_dim=100), False),
                      (tmlp.NeRFConfig(63, 27, skip_pos=0), False),
                      (tmlp.NeRFConfig(63, 27, n_layers=2, skip_pos=1), False),
                      (tmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=128,
                                       skip_pos=2), True)):
        jcfg = jmlp.NeRFConfig(*cfg[:5])
        assert tfm.fusable(cfg) is want
        assert jfm.fusable(jcfg) is want
    assert tfm._enc_pads(TCFG) == jfm._enc_pads(JCFG) == (64, 32)
    with pytest.raises(ValueError):
        tfm.pack_nerf_params(tmlp.NeRFMLP(
            tmlp.NeRFConfig(63, 27, n_layers=2, hidden_dim=32, skip_pos=1),
            device="cpu"))


def test_wrapper_device_rules():
    _, m, ep, ed = _setup(seed=3, q=8)
    elsewhere = tfm.pack_nerf_params(m)
    elsewhere = elsewhere._replace(flat=elsewhere.flat.to("meta"))
    with pytest.raises(ValueError, match="model is on"):
        tfm.fused_nerf_apply(elsewhere, torch.from_numpy(ep),
                             torch.from_numpy(ed), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.fused_nerf_apply(m, torch.from_numpy(ep), torch.from_numpy(ed),
                             device="meta")
    before = tfm.fused_nerf_apply.launches
    tfm.fused_nerf_apply(m, torch.from_numpy(ep), torch.from_numpy(ed),
                         device="cpu")
    assert tfm.fused_nerf_apply.launches == before   # the plain path launches nothing
