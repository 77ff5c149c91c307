"""K1's plain PyTorch version (``ops/fused_mlp.py``) against the JAX fused MLP
(Pallas, interpret mode) and ``nerf_apply`` in bf16, on the CPU. The CUDA
kernel itself is held against this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 0.05 against both JAX functions (the JAX fused-MLP test's bf16
bound); 1e-5 for padding independence (rows never mix). The staged weight
stream the CUDA kernels copy into shared memory is checked bit-exact: it
must invert to the packed views, and its first chunk must sit where the
kernels' wgmma descriptors read it.
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


@pytest.mark.parametrize("hidden", [384, 512, 640])
def test_wide_plain_matches_jax_fused_and_nerf_apply_bf16(hidden):
    """Hidden widths 384 and 512 (the kernels' wide path) and 640 (their
    large route); 3 layers, skip 1."""
    jcfg = jmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=hidden, skip_pos=1)
    params = jmlp.init_nerf_params(jax.random.PRNGKey(hidden), jcfg)
    m = tmlp.NeRFMLP(tmlp.NeRFConfig(*jcfg), device="cpu")
    m.load_state_dict(tmlp.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(hidden)
    ep = (rng.normal(size=(200, 63)) * 0.5).astype(np.float32)
    ed = (rng.normal(size=(200, 27)) * 0.5).astype(np.float32)
    got = tfm.fused_nerf_apply(m, torch.from_numpy(ep), torch.from_numpy(ed),
                               device="cpu").numpy()
    fused = np.asarray(jfm.fused_nerf_apply(params, jcfg, jnp.asarray(ep),
                                            jnp.asarray(ed), interpret=True))
    bf16 = np.asarray(jmlp.nerf_apply(params, jcfg, jnp.asarray(ep),
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


def _unstage(cfg, staged):
    """Invert ``stage_weights``: → the (K, N) arrays of ``_stream_layers``,
    padding rows included (W_c1's enc_dir rows to a multiple of 64)."""
    H, kc = cfg.hidden_dim, tfm.KC
    ep, ed = tfm._enc_pads(cfg)
    ks = [ep] + [k for layer in range(1, cfg.n_layers)
                 for k in ((H, ep) if layer == cfg.skip_pos else (H,))] + [H]
    shapes = [(k, H) for k in ks] + [(H, H // 2), (-(-ed // kc) * kc, H // 2)]
    out, off = [], 0
    for K, N in shapes:
        chunks = tfm._swizzle_rows(staged[off:off + K * N].reshape(K // kc, N, kc))
        out.append(chunks.transpose(1, 2).reshape(K, N))
        off += K * N
    assert off == staged.numel()
    return out


STAGE_CFGS = {"8x256": TCFG,
              "3x128": tmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=128,
                                       skip_pos=2),
              "kplanes_ep128": tmlp.NeRFConfig(71, 27, n_layers=8, hidden_dim=256,
                                               skip_pos=4)}


@pytest.mark.parametrize("name", STAGE_CFGS)
def test_staged_weights_invert_to_views(name):
    cfg = STAGE_CFGS[name]
    m = tmlp.NeRFMLP(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    packed = tfm.pack_nerf_params(m)
    arrays = [w for layer in tfm._stream_layers(cfg, packed.views) for w in layer]
    got = _unstage(cfg, packed.staged)
    assert len(got) == len(arrays)
    for g, w in zip(got, arrays):
        k = w.shape[0]
        assert g.dtype == torch.bfloat16 and g.shape[1] == w.shape[1]
        assert g.shape[0] % tfm.KC == 0 and g.shape[0] - k < tfm.KC
        assert torch.equal(g[:k], w)                  # bit-exact
        assert not g[k:].float().any()                 # zero padding rows
    # chunk 0 is W0[0:64, :] as H rows of 64 K values, unit u of row n at
    # u ^ (n % 8): the 128-byte swizzle of the kernels' descriptors
    H = cfg.hidden_dim
    chunk = packed.staged[:tfm.KC * H].reshape(H, 8, 8)
    n, k = torch.meshgrid(torch.arange(H), torch.arange(tfm.KC), indexing="ij")
    phys = chunk[n, (k // 8) ^ (n % 8), k % 8]
    assert torch.equal(phys, packed.views["w0"][:tfm.KC].T)
    ep = tfm._enc_pads(cfg)[0]
    n_trunk = 2 * ep // tfm.KC + cfg.n_layers * H // tfm.KC
    n_colour = H // tfm.KC + 1
    assert packed.staged.numel() == (n_trunk * tfm.KC * H
                                     + n_colour * tfm.KC * (H // 2))


@pytest.mark.parametrize("hidden", [384, 512])
def test_wide_staged_weights_invert_to_layers(hidden):
    """The wide path's stream: per matmul, per output chunk of
    ``large_chunks`` (256 columns, then a 128 or 64 tail), per array, per 64
    K rows, the chunk's stages of 64 x NCW (two for a 256-column chunk, one
    of 64 columns for a 64-column tail). Taking it apart stage by stage gives
    back every array of ``_stream_layers``, bit for bit, and the stage count
    the kernel's producer cycles through."""
    cfg = tmlp.NeRFConfig(63, 27, n_layers=4, hidden_dim=hidden, skip_pos=2)
    m = tmlp.NeRFMLP(cfg, generator=torch.Generator().manual_seed(6), device="cpu")
    packed = tfm.pack_nerf_params(m)
    staged, kc, ncw = packed.staged, tfm.KC, tfm.NCW
    off = stages = 0
    for layer in tfm._stream_layers(cfg, packed.views):
        n_out = layer[0].shape[1]
        rebuilt = [torch.zeros((-(-w.shape[0] // kc) * kc, n_out), dtype=torch.bfloat16)
                   for w in layer]
        n = 0
        for nc in tfm.large_chunks(n_out):       # chunk by chunk, in kernel order
            sw = min(nc, ncw)
            for r in rebuilt:
                for k in range(0, r.shape[0], kc):
                    for h in range(n, n + nc, sw):
                        st = tfm._swizzle_rows(staged[off:off + kc * sw].reshape(1, sw, kc))
                        r[k:k + kc, h:h + sw] = st[0].T
                        off += kc * sw
                        stages += 1
            n += nc
        assert n == n_out
        for w, r in zip(layer, rebuilt):
            assert torch.equal(r[:w.shape[0]], w)
            assert not r[w.shape[0]:].float().any()
    assert off == staged.numel()
    # the producer's walk (csrc/mlp_tile.cuh, mlp_produce<ROUTE_WIDE>): matmul K of EP,
    # H, H + EP at the skip, H (feature), H + EDP (colour); per chunk K / 64
    # steps of one stage per NCW columns
    ep, ed = tfm._enc_pads(cfg)
    edp = -(-ed // kc) * kc
    ks = [ep] + [hidden + ep if l == cfg.skip_pos else hidden
                 for l in range(1, cfg.n_layers)] + [hidden, hidden + edp]
    widths = [hidden] * (cfg.n_layers + 1) + [hidden // 2]
    assert stages == sum(k // kc * -(-c // ncw) for k, n in zip(ks, widths)
                         for c in tfm.large_chunks(n))
    # stages 0 and 1 are W0[0:64, 0:128] and W0[0:64, 128:256], each as 128
    # rows of 64 K values, swizzled
    n, k = torch.meshgrid(torch.arange(ncw), torch.arange(kc), indexing="ij")
    for i in range(2):
        st = staged[i * kc * ncw:(i + 1) * kc * ncw].reshape(ncw, 8, 8)
        assert torch.equal(st[n, (k // 8) ^ (n % 8), k % 8],
                           packed.views["w0"][:kc, i * ncw:(i + 1) * ncw].T)


@pytest.mark.parametrize("hidden", [640, 1024, 1152])
def test_large_staged_weights_invert_to_layers(hidden):
    """The large route's stream: per matmul, per output chunk of
    ``large_chunks`` (256 columns, then a 128 or 64 tail), the chunk's 64 x
    width stages of each of its arrays in K order. Taking it apart stage by
    stage gives back every array of ``_stream_layers``, bit for bit, and the
    stage count the kernel's producer cycles through (per matmul, its chunks
    times its K / 64)."""
    cfg = tmlp.NeRFConfig(63, 27, n_layers=3, hidden_dim=hidden, skip_pos=2)
    m = tmlp.NeRFMLP(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    packed = tfm.pack_nerf_params(m)
    staged, kc = packed.staged, tfm.KC
    off = stages = 0
    for layer in tfm._stream_layers(cfg, packed.views):
        n_out = layer[0].shape[1]
        rebuilt = [torch.zeros((-(-w.shape[0] // kc) * kc, n_out), dtype=torch.bfloat16)
                   for w in layer]
        n = 0
        for nc in tfm.large_chunks(n_out):       # chunk by chunk, in kernel order
            for r in rebuilt:
                kp = r.shape[0]
                st = tfm._swizzle_rows(staged[off:off + kp * nc].reshape(kp // kc, nc, kc))
                r[:, n:n + nc] = st.transpose(1, 2).reshape(kp, nc)
                off += kp * nc
                stages += kp // kc
            n += nc
        assert n == n_out
        for w, r in zip(layer, rebuilt):
            assert torch.equal(r[:w.shape[0]], w)
            assert not r[w.shape[0]:].float().any()
    assert off == staged.numel()
    # the producer's walk (csrc/mlp_tile.cuh, mlp_produce for LargeMlpArgs):
    # matmul K of EP, H, H + EP at the skip, H (feature), H + EDP (colour)
    ep, ed = tfm._enc_pads(cfg)
    edp = -(-ed // kc) * kc
    ks = [ep] + [hidden + ep if l == cfg.skip_pos else hidden
                 for l in range(1, cfg.n_layers)] + [hidden, hidden + edp]
    widths = [hidden] * (cfg.n_layers + 1) + [hidden // 2]
    assert stages == sum(len(tfm.large_chunks(n)) * k // kc for k, n in zip(ks, widths))
    # stage 0 is W0[0:64, 0:256] as 256 rows of 64 K values, swizzled
    st = staged[:kc * tfm.LNC].reshape(tfm.LNC, 8, 8)
    n, k = torch.meshgrid(torch.arange(tfm.LNC), torch.arange(kc), indexing="ij")
    assert torch.equal(st[n, (k // 8) ^ (n % 8), k % 8], packed.views["w0"][:kc, :tfm.LNC].T)


@pytest.mark.parametrize("hidden,trunk,head", [
    (640, [256, 256, 128], [256, 64]),
    (768, [256, 256, 256], [256, 128]),
    (1024, [256, 256, 256, 256], [256, 256]),
    (1152, [256, 256, 256, 256, 128], [256, 256, 64])])
def test_large_chunk_plan_has_its_tails(hidden, trunk, head):
    """The large route's output chunks: 256 columns while that many remain,
    then a tail of 128 or 64, for the trunk's H and the colour head's H / 2;
    each a width the kernel has a wgmma for (m64nNk16, N = 64, 128, 256)."""
    assert tfm.large_chunks(hidden) == trunk
    assert tfm.large_chunks(hidden // 2) == head
    assert all(w in (64, 128, tfm.LNC) for w in trunk + head)


@pytest.mark.parametrize("hidden,trunk,head", [
    (384, [256, 128], [128, 64]),
    (512, [256, 256], [256])])
def test_wide_chunk_plan(hidden, trunk, head):
    """The wide path's output chunks (``mlp_pass_wide``'s compile-time plan):
    a first chunk of 256 columns, parked in registers, then a last of 256 or
    128; the colour head in one chunk of 256, or 128 then 64. A chunk wider
    than a stage's NCW columns takes two stages per 64 K rows."""
    assert tfm.large_chunks(hidden) == trunk
    assert tfm.large_chunks(hidden // 2) == head
    assert trunk[0] == tfm.LNC and len(trunk) == 2 and len(head) <= 2
    assert [-(-w // tfm.NCW) for w in trunk + head] == [
        2 if w == tfm.LNC else 1 for w in trunk + head]


@pytest.mark.parametrize("shape", [
    (8, 256, 4), (3, 128, 1), (8, 384, 4), (8, 512, 4), (8, 640, 4),
    (8, 1024, 4), (3, 1152, 2), (8, 192, 4), (8, 256, 0), (8, 256, 8),
    (2, 256, 1)])
def test_kernel_shape_check_names_hidden_widths(shape):
    """The kernels take exactly the MLPs JAX's ``fusable`` takes: every
    multiple of 128 (128 / 256 in registers, 384 / 512 the wide path, wider
    the large route), a skip layer inside the trunk, at least three layers.
    Elsewhere the check raises and names the rule."""
    n_layers, hidden, skip = shape
    cfg = tmlp.NeRFConfig(63, 27, n_layers=n_layers, hidden_dim=hidden,
                          skip_pos=skip)
    if jfm.fusable(jmlp.NeRFConfig(*cfg[:5])):
        tfm.check_kernel_shape(cfg)
        assert tfm.is_large(cfg) == (hidden > 512)
    else:
        with pytest.raises(ValueError, match="fusable.*multiple of 128.*"
                           "skip_pos.*n_layers >= 3"):
            tfm.check_kernel_shape(cfg)


def test_wgmma_header_matches_its_generator():
    """csrc/wgmma.cuh is written by csrc/gen_wgmma.py; they must not drift."""
    import importlib.util
    from pathlib import Path
    csrc = Path(tfm.__file__).resolve().parent.parent / "csrc"
    spec = importlib.util.spec_from_file_location("gen_wgmma", csrc / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    text = gen.render()
    assert text == (csrc / "wgmma.cuh").read_text()
    for n in (64, 128, 256):
        assert f"m64n{n}k16.f32.bf16.bf16" in text


def test_weight_stream_probe_finds_the_producer_copy():
    """``probe_weight_stream`` patches the producer's bulk copy out of a copy
    of csrc/mlp_tile.cuh; the text it replaces must be there exactly once."""
    from pathlib import Path

    from nerf_sandbox_tpu_torch import probe_weight_stream as probe
    tile = Path(tfm.__file__).resolve().parent.parent / "csrc" / "mlp_tile.cuh"
    assert tile.read_text().count(probe.COPY) == 1


@pytest.mark.parametrize("name", ["as is", "no epilogue stores", "no A copies",
                                  "no layer barrier", "4 A slots", "word stores"])
def test_large_route_probe_finds_its_edits(name):
    """``probe_large_route`` edits a copy of csrc/mlp_tile.cuh once per
    variant; every text it replaces must be there exactly once, and every
    variant but the unedited one must change the file."""
    from pathlib import Path

    from nerf_sandbox_tpu_torch import probe_large_route as probe
    from nerf_sandbox_tpu_torch.compare_builds import edited_sources
    csrc = Path(tfm.__file__).resolve().parent.parent / "csrc"
    assert set(probe.VARIANTS) == {"as is", "no epilogue stores", "no A copies",
                                   "no layer barrier", "4 A slots", "word stores"}
    edited = edited_sources(csrc, {"mlp_tile.cuh": probe.VARIANTS[name]})["mlp_tile.cuh"]
    assert (edited == (csrc / "mlp_tile.cuh").read_text()) == (name == "as is")


@pytest.mark.parametrize("name", ["as is", "no layer-end stores", "no sigma read-back",
                                  "plain stores"])
def test_wide_route_probe_finds_its_edits(name):
    """``probe_large_route --route wide`` edits a copy of csrc/mlp_tile.cuh
    once per wide variant; every text it replaces must be there exactly
    once, and every variant but the unedited one must change the file."""
    from pathlib import Path

    from nerf_sandbox_tpu_torch import probe_large_route as probe
    from nerf_sandbox_tpu_torch.compare_builds import edited_sources
    csrc = Path(tfm.__file__).resolve().parent.parent / "csrc"
    assert set(probe.WIDE_VARIANTS) == {"as is", "no layer-end stores",
                                        "no sigma read-back", "plain stores"}
    edited = edited_sources(csrc, {"mlp_tile.cuh": probe.WIDE_VARIANTS[name]})
    assert (edited["mlp_tile.cuh"] == (csrc / "mlp_tile.cuh").read_text()) == (name == "as is")
