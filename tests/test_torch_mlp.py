"""The port's NeRF MLP module, forward pass, weight carry-over and checkpoint
reader against the JAX package and the torch reference's golden outputs, on
the CPU.

Tolerances: fp32 forward 1e-4 absolute against ``nerf_apply`` (summation
order over 8 layers of 256); bf16 forward 0.05 (the JAX fused-MLP test's
bf16 bound: both sides round every product to bf16, at places that can
differ by accumulation order); weight carry-over and checkpoint reading
exact; an IPE-trained checkpoint's fp32 render 1e-4 (depth 1e-3).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_sandbox_tpu.core.encoding import vanilla_encoders
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.models.forward import nerf_forward_pass as jfwd
from nerf_sandbox_tpu.render import renderer as jr
from nerf_sandbox_tpu.train.checkpoints import save_checkpoint
from nerf_sandbox_tpu.train.step import TrainState
from nerf_sandbox_tpu_torch.core.encoding import positional_encoding
from nerf_sandbox_tpu_torch.models import mlp as tmlp
from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass as tfwd
from nerf_sandbox_tpu_torch.render import renderer as tr
from nerf_sandbox_tpu_torch.train import checkpoints as tckpt

JCFG = jmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27)
TCFG = tmlp.NeRFConfig(enc_pos_dim=63, enc_dir_dim=27)
SMALL_J = jmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=32, skip_pos=1)
SMALL_T = tmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=32, skip_pos=1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(jax_params, cfg):
    m = tmlp.NeRFMLP(cfg, device="cpu")
    m.load_state_dict(tmlp.params_from_jax(_np_tree(jax_params)))
    return m


def _enc(q, seed):
    rng = np.random.RandomState(seed)
    return ((rng.normal(size=(q, 63)) * 0.5).astype(np.float32),
            (rng.normal(size=(q, 27)) * 0.5).astype(np.float32))


def test_trunk_dims_and_param_layout(golden):
    assert tmlp.trunk_in_dims(TCFG) == jmlp.trunk_in_dims(JCFG)
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    sd = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                   "mlp_state.npz")))
    assert set(m.state_dict()) == set(sd)
    assert all(tuple(m.state_dict()[k].shape) == sd[k].shape for k in sd)
    assert sum(p.numel() for p in m.parameters()) == int(golden["mlp_n_params"])


def test_golden_state_dict_forward(golden):
    sd = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "mlp_state.npz"))
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    m.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    with torch.no_grad():
        out = m(torch.from_numpy(golden["mlp_enc_pos"]),
                torch.from_numpy(golden["mlp_enc_dir"]))
    # the JAX test's tolerance against the reference
    np.testing.assert_allclose(out.numpy(), golden["mlp_out"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_nerf_apply(dtype):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(0), JCFG)
    m = _port_model(params, TCFG)
    ep, ed = _enc(300, 1)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    want = np.asarray(jmlp.nerf_apply(params, JCFG, jnp.asarray(ep),
                                      jnp.asarray(ed), compute_dtype=jdt))
    with torch.no_grad():
        got = m(torch.from_numpy(ep), torch.from_numpy(ed),
                compute_dtype=tdt).numpy()
    assert got.dtype == np.float32 and got.shape == (300, 4)
    np.testing.assert_allclose(got, want, atol=1e-4 if tdt is None else 0.05)


FORWARD_MODES = {
    "fp32": (jnp.float32, {}),
    "bf16": (jnp.bfloat16, {"compute_dtype": torch.bfloat16}),
    "kernel_twin": (jnp.bfloat16, {"use_kernel": True}),
}


@pytest.mark.parametrize("mode", FORWARD_MODES)
def test_forward_pass_matches_jax_and_golden(golden, mode):
    """``nerf_forward_pass`` on the golden rays with the reference's weights:
    fp32 against the reference's outputs (the JAX forward test's
    tolerances) and JAX at 1e-5 (depth 1e-4); bf16 and the K1 route (its
    plain version on the CPU) against JAX bf16 at 2e-2 (depth 0.1). Every
    ray's last sigma logit is > 0.1 from the infinite last bin's step."""
    sd = dict(np.load(os.path.join(os.path.dirname(__file__), "golden",
                                   "mlp_state.npz")))
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = jmlp.params_from_torch_state_dict(sd, JCFG)
    pos_b, dir_b = vanilla_encoders()
    ro, rd, z, rn, vd = (golden[f"fw_{k}"] for k in ("ro", "rd", "z", "rn", "vd"))
    jdt, tkw = FORWARD_MODES[mode]
    kw = dict(white_bkgd=True, sigma_activation="relu", infinite_last_bin=True)
    want = jfwd(params, JCFG, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                pos_bands=jnp.asarray(pos_b), dir_bands=jnp.asarray(dir_b),
                ray_norms=jnp.asarray(rn), viewdirs_world_unit=jnp.asarray(vd),
                compute_dtype=jdt, **kw)
    with torch.no_grad():
        got = tfwd(m, *map(torch.from_numpy, (ro, rd, z)), pos_bands=pos_b,
                   dir_bands=dir_b, ray_norms=torch.from_numpy(rn),
                   viewdirs_world_unit=torch.from_numpy(vd), device="cpu",
                   **tkw, **kw)
        enc_last = positional_encoding(torch.from_numpy(ro + rd * (z[:, -1:] * rn)),
                                       pos_b)
        last_logit = m(enc_last, positional_encoding(torch.from_numpy(vd), dir_b))
    assert float(last_logit[:, 3].abs().min()) > 0.1
    names = ("comp", "w", "acc", "depth")
    if mode == "fp32":
        for g, n, rtol, atol in zip(got, names, (1e-4, 1e-3, 1e-4, 1e-3),
                                    (2e-4, 2e-4, 2e-4, 1e-3)):
            np.testing.assert_allclose(g.numpy(), golden[f"fw_{n}"], rtol=rtol,
                                       atol=atol, err_msg=f"{n} vs golden")
    tols = (1e-5, 1e-5, 1e-5, 1e-4) if mode == "fp32" else (2e-2, 2e-2, 2e-2, 0.1)
    for g, w, n, tol in zip(got, want, names, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   err_msg=f"{n} vs JAX")


def test_params_from_jax_round_trip():
    """JAX pytree → port state dict is the exact inverse of the JAX
    package's ``params_from_torch_state_dict``."""
    sd = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "mlp_state.npz"))
    tree = _np_tree(jmlp.params_from_torch_state_dict(dict(sd), JCFG))
    back = tmlp.params_from_jax(tree)
    assert set(back) == set(sd.files)
    for k in sd.files:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    params = _np_tree(jmlp.init_nerf_params(jax.random.PRNGKey(3), SMALL_J))
    sd2 = tmlp.params_from_jax(params)
    tree2 = _np_tree(jmlp.params_from_torch_state_dict(
        {k: v.numpy() for k, v in sd2.items()}, SMALL_J))
    for a, b in zip(jax.tree_util.tree_leaves(tree2),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # a k-planes pos_grid converts (tests/test_torch_kplanes.py); appearance
    # codes do not yet
    with pytest.raises(NotImplementedError, match="P7 item 7"):
        tmlp.params_from_jax({**params, "app_emb": np.zeros((4, 8))})


def test_seeded_init_distributions():
    """Same distributions as ``init_nerf_params``: Kaiming-uniform trunk and
    colour_fc (relu gain) and feature (gain 1) with zero biases; sigma_out
    and color_out U(±1/sqrt(fan_in)); deterministic per generator seed."""
    g = torch.Generator().manual_seed(5)
    m = tmlp.NeRFMLP(TCFG, generator=g, device="cpu")
    m2 = tmlp.NeRFMLP(TCFG, generator=torch.Generator().manual_seed(5),
                      device="cpu")
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    jp = jmlp.init_nerf_params(jax.random.PRNGKey(0), JCFG)

    def check(layer, jlayer, bound, zero_bias):
        w = layer.weight.detach().numpy()
        assert np.abs(w).max() <= bound + 1e-7
        # a uniform on ±bound has std bound/sqrt(3): within 5% here
        assert abs(w.std() - bound / math.sqrt(3)) < 0.05 * bound
        assert abs(w.std() - np.asarray(jlayer["w"]).std()) < 0.05 * bound
        if zero_bias:
            assert not layer.bias.detach().any()

    for i, layer in enumerate(m.mlp):
        check(layer, jp["trunk"][i],
              math.sqrt(2.0) * math.sqrt(3.0 / layer.in_features), True)
    check(m.feature, jp["feature"], math.sqrt(3.0 / 256), True)
    check(m.color_fc, jp["color_fc"], math.sqrt(2.0) * math.sqrt(3.0 / 283), True)
    check(m.color_out, jp["color_out"], 1.0 / math.sqrt(128), False)
    assert np.abs(m.sigma_out.weight.detach().numpy()).max() <= 1 / 16 + 1e-7


def test_initial_acc_opacity_init():
    m = tmlp.NeRFMLP(SMALL_T, initial_acc_opacity=0.3, near=2.0, far=6.0,
                     device="cpu")
    jp = jmlp.init_nerf_params(jax.random.PRNGKey(0), SMALL_J,
                               initial_acc_opacity=0.3, near=2.0, far=6.0)
    np.testing.assert_allclose(m.sigma_out.bias.detach().numpy(),
                               np.asarray(jp["sigma_out"]["b"]), rtol=1e-6)
    assert not m.color_out.bias.detach().any()
    assert (tmlp.sigma_bias_for_initial_acc_opacity(0.5, 2, 6, "relu")
            == jmlp.sigma_bias_for_initial_acc_opacity(0.5, 2, 6, "relu"))


def test_appearance_codes_raise():
    with pytest.raises(NotImplementedError, match="P7"):
        tmlp.NeRFMLP(tmlp.NeRFConfig(63, 27, app_dim=8), device="cpu")


def test_load_params_from_jax_ckpt(tmp_path):
    pc = jmlp.init_nerf_params(jax.random.PRNGKey(1), SMALL_J)
    pf = jmlp.init_nerf_params(jax.random.PRNGKey(2), SMALL_J)
    state = TrainState(step=jnp.int32(42), params_c=pc, params_f=pf,
                       opt_state=None)
    path = save_checkpoint(tmp_path / "checkpoints", 42, state, {"lr": 5e-4},
                           include_optim=False)
    sd_c, sd_f = tckpt.load_params_from_jax_ckpt(path)
    for sd, tree in ((sd_c, pc), (sd_f, pf)):
        want = tmlp.params_from_jax(_np_tree(tree))
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k
    # the loaded weights drive the port to the JAX forward exactly as
    # converted ones do
    m = tmlp.NeRFMLP(SMALL_T, device="cpu")
    m.load_state_dict(sd_f)
    ep, ed = _enc(16, 4)
    with torch.no_grad():
        got = m(torch.from_numpy(ep), torch.from_numpy(ed)).numpy()
    want = np.asarray(jmlp.nerf_apply(pf, SMALL_J, jnp.asarray(ep),
                                      jnp.asarray(ed)))
    np.testing.assert_allclose(got, want, atol=1e-4)

    assert tckpt.find_latest_checkpoint(tmp_path / "checkpoints", tmp_path) == path
    step, cfg = tckpt.peek_checkpoint_meta(tmp_path)
    assert step == 42 and cfg["lr"] == 5e-4
    assert tckpt.step_of_path(path) == 42
    assert tckpt.peek_checkpoint_meta(tmp_path / "nothing") is None


def test_ipe_checkpoint_renders_in_the_port(tmp_path):
    """IPE adds no parameters and keeps the frequency encoder's 63 columns,
    so a checkpoint of an IPE-trained JAX run loads through the reader and
    renders, with ``EvalHyper(ipe=True)``, the JAX renderer's numbers."""
    pc = jmlp.init_nerf_params(jax.random.PRNGKey(4), SMALL_J)
    pf = jmlp.init_nerf_params(jax.random.PRNGKey(5), SMALL_J)
    state = TrainState(step=jnp.int32(7), params_c=pc, params_f=pf,
                       opt_state=None)
    path = save_checkpoint(tmp_path / "checkpoints", 7, state,
                           {"ipe": True, "vanilla": True}, include_optim=False)
    sd_c, _ = tckpt.load_params_from_jax_ckpt(path)
    assert tckpt.peek_checkpoint_meta(tmp_path)[1]["ipe"] is True
    model_c = tmlp.NeRFMLP(SMALL_T, device="cpu")
    model_c.load_state_dict(sd_c)
    pos_b, dir_b = vanilla_encoders()
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    hyper = dict(nc_eval=8, nf_eval=0, ipe=True, compute_dtype="float32")
    jtile = jr.make_tile_renderer(jr.EvalHyper(model=SMALL_J, **hyper),
                                  jnp.asarray(pos_b), jnp.asarray(dir_b))
    want = jr.render_pose(jtile, pc, None, c2w, 8, 8, K, eval_chunk=32)
    ttile = tr.make_tile_renderer(tr.EvalHyper(model=SMALL_T, **hyper), pos_b,
                                  dir_b, device="cpu")
    got = tr.render_pose(ttile, model_c, None, c2w, 8, 8, K, eval_chunk=32,
                         device="cpu")
    for key, tol in (("rgb", 1e-4), ("acc", 1e-4), ("depth", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], atol=tol, err_msg=key)
    assert got["rgb"].std() > 1e-2


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_sigma_noise_matches_jax(dtype):
    """Train-time sigma noise: JAX draws ``normal(noise_key, (B·N,))`` and
    adds ``noise·raw_noise_std`` to the pre-activation sigma; the same draws
    given as ``noise=`` give the same composite and weights (JAX's
    tolerances of the noise-free forward test: fp32 1e-5, bf16 2e-2), and
    differ from the noise-free pass."""
    jdt, tkw = FORWARD_MODES[dtype]
    rng = np.random.RandomState(5)
    B, N = 16, 24
    ro = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (B, N)), axis=-1).astype(np.float32)
    params = jmlp.init_nerf_params(jax.random.PRNGKey(3), JCFG)
    m = tmlp.NeRFMLP(TCFG, device="cpu")
    m.load_state_dict(tmlp.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    pos_b, dir_b = vanilla_encoders()
    key = jax.random.PRNGKey(11)
    kw = dict(white_bkgd=True, sigma_activation="relu", infinite_last_bin=True)
    want = jfwd(params, JCFG, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                pos_bands=jnp.asarray(pos_b), dir_bands=jnp.asarray(dir_b),
                compute_dtype=jdt, raw_noise_std=1.0, noise_key=key, **kw)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B * N,))))
    with torch.no_grad():
        got = tfwd(m, *map(torch.from_numpy, (ro, rd, z)), pos_bands=pos_b,
                   dir_bands=dir_b, raw_noise_std=1.0, noise=noise.reshape(B, N),
                   device="cpu", **tkw, **kw)
        clean = tfwd(m, *map(torch.from_numpy, (ro, rd, z)), pos_bands=pos_b,
                     dir_bands=dir_b, device="cpu", **tkw, **kw)
    tol = 1e-5 if dtype == "fp32" else 2e-2
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    assert float((got[1] - clean[1]).abs().max()) > 1e-3
