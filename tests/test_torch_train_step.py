"""The port's training step (``nerf_sandbox_tpu_torch/train/step.py``)
against JAX ``build_train_step`` (``scan_steps`` 0) on the CPU: the same
parameters (``params_from_jax`` of the JAX state), the same scene and the
draws JAX makes on its own keys (pixels, stratified jitter, sigma noise,
``sample_pdf`` uniforms) handed to the port.

The jitted JAX step is not JAX's own arithmetic run op by op: XLA fuses and
reorders on the CPU, which moves the coarse weights by ~2e-5, and that can
move a fine sample of a ray by 2e-4 and a gradient entry by up to 5% of its
array's largest (8-layer vanilla, fp32; 12% in bf16). So the gradients are
held twice: tightly against JAX's gradient of the same loss computed
without jit (``_coarse_fine_losses`` on the step's keys), and against the
jitted step's Adam moments within that step's own jit-versus-op-by-op
spread. What is held, after one step unless said otherwise:

* the loss, the PSNR and the fine MSE against the jitted step: fp32 rtol
  5e-5 (measured up to 2.0e-5), bf16 rtol 2e-3 (measured up to 2.3e-4);
* the port's gradient (``step.loss_and_grads``) against JAX's op-by-op
  gradient, per array: fp32 ``|Δ| <= 2e-3·max|ref|`` (measured up to
  4.2e-4), bf16 ``<= 3e-2·max|ref|`` (measured up to 1.3e-2: a bf16
  rounding flip moves single entries);
* the port's parameters after the step against optax's update of the
  port's own gradient (the clip, both Adams, the schedule, the grid decay):
  rtol 1e-6;
* Adam's moments against the jitted step's, entry by entry:
  ``|Δ| <= 2·|jit − op by op| + (2e-3 or 3e-2)·max|ref|``;
* the optimizer's counts (one per Adam of optax's ``multi_transform``) and
  the step exactly, and the learning rate each
  count takes (rtol 1e-6, the cosine in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_sandbox_tpu.core.encoding import vanilla_encoders as j_vanilla_encoders
from nerf_sandbox_tpu.data import sampler as jsampler
from nerf_sandbox_tpu.data.scene import Frame as JFrame, Scene as JScene
from nerf_sandbox_tpu.models import mlp as jmlp
from nerf_sandbox_tpu.models.kplanes import KPlanesConfig as JKPlanesConfig, kplanes_tv
from nerf_sandbox_tpu.train import step as jstep
from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
from nerf_sandbox_tpu_torch.data import sampler as tsampler
from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, params_from_jax
from nerf_sandbox_tpu_torch.train import step as tstep

B, NC, NF, H_IMG, W_IMG = 64, 8, 16, 12, 16
LR = 5e-4
KP = dict(plane_res=(8, 16), plane_features=4, line_res=16, line_features=4,
          aabb_scale=2.0, hybrid_freqs=2)


def _frames():
    rng = np.random.RandomState(0)
    out = []
    for i in range(3):
        K = np.array([[14.0, 0, W_IMG / 2], [0, 14.0, H_IMG / 2], [0, 0, 1]], np.float32)
        th = 0.35 * i
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
        out.append(dict(image=rng.randint(0, 256, (H_IMG, W_IMG, 4)).astype(np.uint8),
                        K=K, c2w=c2w))
    return out


FRAMES = _frames()
J_SCENE = jsampler.SceneArrays.from_scene(JScene([JFrame(**f) for f in FRAMES]))
T_SCENE = tsampler.SceneArrays.from_scene(Scene([Frame(**f) for f in FRAMES]),
                                          device="cpu")


def _recipe(name, compute):
    """(hyper kwargs, optimizer kwargs, near, far) of a case."""
    hk = dict(nc=NC, nf=NF, compute_dtype=compute)
    ok = dict(scheduler="cosine", scheduler_params={"T_max": 100, "eta_min": 5e-6})
    near, far = 2.0, 6.0
    if name in ("vanilla", "micro2", "clip"):
        pass
    elif name == "ipe":
        hk.update(ipe=True)
    elif name == "kplanes360":
        hk.update(pos_encoder="kplanes", scene_contraction=True, lindisp=True,
                  distortion_weight=0.01, distortion_anneal_steps=4,
                  kp_tv_weight=0.05, infinite_last_bin=False, white_bkgd=False)
        ok.update(grid_lr=1e-2, grid_weight_decay=1e-3, grid_decay_target=1.0)
        near, far = 0.5, 8.0
    if name == "micro2":
        hk.update(micro_chunks=2)
    if name == "clip":
        ok.update(grad_clip_norm=1e-3)
    return hk, ok, near, far


def _setup(name, compute="float32", opt_kw=None, seed=0):
    hk, ok, near, far = _recipe(name, compute)
    ok.update(opt_kw or {})
    kp = hk.get("pos_encoder") == "kplanes"
    n_pos = (len(KP["plane_res"]) * KP["plane_features"] + KP["line_features"]
             + 3 + 6 * KP["hybrid_freqs"]) if kp else 63
    jcfg = jmlp.NeRFConfig(n_pos, 27, n_layers=4, hidden_dim=64, skip_pos=2)
    tcfg = NeRFConfig(n_pos, 27, n_layers=4, hidden_dim=64, skip_pos=2)
    jh = jstep.TrainHyper(model=jcfg, samp_near=near, samp_far=far,
                          enc_cfg=JKPlanesConfig(**KP) if kp else None, **hk)
    th = tstep.TrainHyper(model=tcfg, samp_near=near, samp_far=far,
                          enc_cfg=KPlanesConfig(**KP) if kp else None, **hk)
    spec_kw = dict(rays_per_batch=B, image_h=H_IMG, image_w=W_IMG)
    jtx, ttx = jstep.make_optimizer(LR, **ok), tstep.make_optimizer(LR, **ok)
    jstate = jstep.init_train_state(jax.random.PRNGKey(seed), jh, jtx, near=near, far=far)
    params = tuple(params_from_jax(jax.tree_util.tree_map(np.asarray, p))
                   for p in (jstate.params_c, jstate.params_f))
    tstate = tstep.init_train_state(th, ttx, near=near, far=far, params=params,
                                    device="cpu")
    jpb, jdb = j_vanilla_encoders()
    jfn = jstep.build_train_step(jh, jsampler.RayBatchSpec(**spec_kw), jtx,
                                 jnp.asarray(jpb), jnp.asarray(jdb), scan_steps=0)
    tpb, tdb = vanilla_encoders()
    tfn = tstep.build_train_step(th, tsampler.RayBatchSpec(**spec_kw), ttx, tpb, tdb,
                                 device="cpu")
    return dict(jh=jh, th=th, jtx=jtx, ttx=ttx, jstate=jstate, tstate=tstate,
                jfn=jfn, tfn=tfn, spec=jsampler.RayBatchSpec(**spec_kw),
                clip=ok.get("grad_clip_norm", 0.0))


def jax_draws(jh, spec, step, base_seed=42):
    """The draws JAX's step ``step`` (1-based) makes on its keys, in the
    port's layout: per micro-chunk keys, rows concatenated."""
    key = jax.random.fold_in(jax.random.PRNGKey(base_seed), step)
    k_batch, k_loss = jax.random.split(key)
    pix = jsampler.sample_pixels(k_batch, jnp.int32(step), J_SCENE, spec)
    m = jh.micro_chunks if jh.micro_chunks > 1 else 1
    keys = jax.random.split(k_loss, m) if m > 1 else [k_loss]
    b = B // m
    parts = {k: [] for k in ("u_strat", "noise_c", "u_pdf", "noise_f")}
    for k in keys:
        kp, knc, kpdf, knf = jax.random.split(k, 4)
        parts["u_strat"].append(jax.random.uniform(kp, (b, NC), dtype=jnp.float32))
        parts["noise_c"].append(jax.random.normal(knc, (b * NC,)).reshape(b, NC))
        parts["u_pdf"].append(jax.random.uniform(kpdf, (b, NF), dtype=jnp.float32))
        parts["noise_f"].append(
            jax.random.normal(knf, (b * (NC + NF),)).reshape(b, NC + NF))
    d = {k: np.concatenate([np.asarray(x) for x in v]) for k, v in parts.items()}
    d.update(fids=np.asarray(pix["frame_ids"]), ys=np.asarray(pix["ys"]),
             xs=np.asarray(pix["xs"]))
    return d


def _port_name(path):
    """A JAX params path → (port parameter name, transpose?)."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    model, rest = keys[0], keys[1:]
    if rest[0] == "trunk":
        return f"{model}.mlp.{rest[1]}.{'weight' if rest[2] == 'w' else 'bias'}", rest[2] == "w"
    if rest[0] == "pos_grid":
        return f"{model}.pos_grid.{rest[1]}", False
    return f"{model}.{rest[0]}.{'weight' if rest[1] == 'w' else 'bias'}", rest[1] == "w"


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, tr = _port_name(path)
        a = np.asarray(leaf, np.float32)
        out[name] = a.T if tr else a
    return out


def _adam(opt_state):
    """JAX's Adam states → (counts, {name: mu}, {name: nu})."""
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu, nu = {}, {}
    for s in states:
        mu.update(_flat(s.mu))
        nu.update(_flat(s.nu))
    return sorted(int(s.count) for s in states), mu, nu


def _jparams(jstate):
    return _flat({"c": jstate.params_c, "f": jstate.params_f})


def _run(ctx, steps=1):
    """Both sides ``steps`` steps from the same state → (JAX metrics list,
    port metrics list, grad tolerance scale)."""
    jm, tm = [], []
    js, ts = ctx["jstate"], ctx["tstate"]
    for i in range(1, steps + 1):
        d = jax_draws(ctx["jh"], ctx["spec"], i)
        js, m = ctx["jfn"](js, J_SCENE)
        jm.append({k: np.asarray(v) for k, v in m.items()})
        ts, m = ctx["tfn"](ts, T_SCENE, d)
        tm.append({k: v.numpy() for k, v in m.items()})
    ctx["jstate"], ctx["tstate"] = js, ts
    return jm, tm


def eager_grads(ctx, step=1):
    """JAX's gradient of the step's loss (``_coarse_fine_losses`` per
    micro-chunk on the step's keys, the distortion ramp, the tables' TV),
    without jit, clipped as the optimizer clips it → {port name: array}."""
    jh = ctx["jh"]
    key = jax.random.fold_in(jax.random.PRNGKey(42), step)
    k_batch, k_loss = jax.random.split(key)
    batch = jsampler.sample_ray_batch(k_batch, jnp.int32(step), J_SCENE, ctx["spec"])
    pb, db = (jnp.asarray(x) for x in j_vanilla_encoders())
    m = jh.micro_chunks if jh.micro_chunks > 1 else 1
    ds = (jnp.clip(step / jh.distortion_anneal_steps, 0.0, 1.0)
          if jh.distortion_weight > 0 and jh.distortion_anneal_steps else None)

    def loss(p):
        keys = jax.random.split(k_loss, m) if m > 1 else [k_loss]
        total = 0.0
        for i, k in enumerate(keys):
            sub = jax.tree_util.tree_map(
                lambda x: x.reshape(m, -1, *x.shape[1:])[i], batch)
            lc, lf = jstep._coarse_fine_losses(p["c"], p["f"], sub, k, jh, pb, db,
                                               dist_scale=ds)
            total = total + lc / m + lf / m
        if jh.kp_tv_weight > 0:
            total = total + jh.kp_tv_weight * (kplanes_tv(p["f"]["pos_grid"])
                                               + kplanes_tv(p["c"]["pos_grid"]))
        return total

    return _flat(jax.grad(loss)({"c": ctx["jstate"].params_c,
                                 "f": ctx["jstate"].params_f}))


def _clipped(g, clip):
    if not clip:
        return g
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
    return {k: v * min(1.0, clip / norm) for k, v in g.items()}


def _jax_tree(flat, template):
    """{port name: array} → a pytree shaped as ``template`` (JAX params)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, _ in paths:
        name, tr = _port_name(path)
        leaves.append(jnp.asarray(flat[name].T if tr else flat[name]))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _hold_step(ctx, compute):
    """One step on both sides from the same state and draws; holds the
    metrics, the port's gradient against JAX's op-by-op one, its parameters
    against optax's update applied to its own gradient, and Adam's moments
    against the jitted step's."""
    js0 = ctx["jstate"]
    p0 = jax.tree_util.tree_map(np.array, {"c": js0.params_c, "f": js0.params_f})
    opt0 = jax.tree_util.tree_map(np.array, js0.opt_state)
    g_eager = eager_grads(ctx)
    d = jax_draws(ctx["jh"], ctx["spec"], 1)
    _, _, g_port, _ = ctx["tfn"].loss_and_grads(ctx["tstate"], T_SCENE, d)
    g_port = {k: v.numpy() for k, v in g_port.items()}
    jm, tm = _run(ctx)
    rtol = 5e-5 if compute == "float32" else 2e-3
    for k in ("loss", "psnr", "mse_f"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=rtol, err_msg=k)
    assert bool(tm[0]["finite"]) and int(tm[0]["skipped"]) == 0

    counts, jmu, jnu = _adam(ctx["jstate"].opt_state)
    ts = ctx["tstate"]
    assert {int(c) for c in ts.opt_state["count"].values()} == set(counts) == {1}
    assert int(ts.step) == int(ctx["jstate"].step) == 1
    assert set(g_port) == set(g_eager) == set(jmu)
    floor = 2e-3 if compute == "float32" else 3e-2
    for k, ge in g_eager.items():
        scale = float(np.abs(ge).max())
        assert np.abs(g_port[k] - ge).max() <= floor * scale + 1e-30, (
            k, float(np.abs(g_port[k] - ge).max()), scale)
    # the optimizer: optax's update of the port's own gradient
    upd, _ = ctx["jtx"].update(_jax_tree(g_port, p0), opt0, p0)
    want = _flat(optax.apply_updates(p0, upd))
    for k, p in tstep.named_params(ts).items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    # the moments against the jitted step's, within its own jit spread
    ge = _clipped(g_eager, ctx["clip"])
    for k in jmu:
        for group, want_j, ref in (("mu", jmu[k], 0.1 * ge[k]),
                                   ("nu", jnu[k], 1e-3 * ge[k] * ge[k])):
            got = ts.opt_state[group][k].numpy()
            tol = 2.0 * np.abs(want_j - ref) + floor * float(np.abs(want_j).max())
            assert np.all(np.abs(got - want_j) <= tol + 1e-30), (
                group, k, float(np.abs(got - want_j).max()), float(np.abs(want_j).max()))


CASES = ["vanilla", "kplanes360", "ipe", "micro2", "clip"]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_one_step_matches_jax(name, compute):
    _hold_step(_setup(name, compute), compute)


def test_clip_binds():
    """The clip case's global gradient norm is far above 1e-3, so the clip
    scales every gradient: mu's norm is 0.1 x 1e-3."""
    ctx = _setup("clip")
    _run(ctx)
    mu = ctx["tstate"].opt_state["mu"]
    norm = float(torch.sqrt(sum(torch.sum(v * v) for v in mu.values())))
    assert abs(norm - 0.1 * 1e-3) < 1e-9


def test_three_step_trajectory_matches_jax():
    """Three steps with the cosine schedule's T_max = 1, so the last update
    runs past T_max (count 2) at eta_min. Each step's loss and PSNR at rtol
    1e-4; after the third step the counts and the step exactly, Adam's
    moments per array within 1e-1 of the array's largest entry (the jitted
    step's own spread compounds over the steps), and nine in ten parameters
    within 1e-3·lr, all within 3·lr."""
    ctx = _setup("vanilla", opt_kw={"scheduler_params": {"T_max": 1, "eta_min": 5e-6}})
    jm, tm = _run(ctx, steps=3)
    for a, b in zip(jm, tm):
        for k in ("loss", "psnr"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=k)
    counts, jmu, jnu = _adam(ctx["jstate"].opt_state)
    ts = ctx["tstate"]
    assert counts == [3] and int(ts.opt_state["count"]["mlp"]) == 3 and int(ts.step) == 3
    for group, ref in (("mu", jmu), ("nu", jnu)):
        for k, want in ref.items():
            got = ts.opt_state[group][k].numpy()
            assert np.abs(got - want).max() <= 1e-1 * np.abs(want).max() + 1e-30, (group, k)
    jp, tp = _jparams(ctx["jstate"]), tstep.named_params(ts)
    for k, want in jp.items():
        got = tp[k].detach().numpy()
        assert np.abs(got - want).max() <= 3 * LR + 1e-6, k
        assert np.mean(np.abs(got - want) <= 1e-3 * LR + 1e-7) > 0.9, k


def test_non_finite_step_is_skipped_like_jax():
    """An infinite texel makes the tables' TV, so the loss, infinite (the
    renders sanitise themselves, the regulariser does not): both sides hold
    the parameters and the whole optimizer state (every count and moment at
    0) and advance the step. The 360 recipe, so both Adams are held."""
    ctx = _setup("kplanes360")
    bad = jax.tree_util.tree_map(np.array, ctx["jstate"].params_f)
    bad["pos_grid"]["plane0_xy"][0, 0, 0] = np.inf
    ctx["jstate"] = ctx["jstate"]._replace(params_f=bad)
    with torch.no_grad():
        ctx["tstate"].model_f.pos_grid.plane0_xy[0, 0, 0] = float("inf")
    before = {k: v.detach().clone() for k, v in tstep.named_params(ctx["tstate"]).items()}
    jm, tm = _run(ctx)
    assert not bool(jm[0]["finite"]) and not bool(tm[0]["finite"])
    assert int(tm[0]["skipped"]) == 1 == int(jm[0]["skipped"])
    assert int(ctx["tstate"].step) == 1 == int(ctx["jstate"].step)
    counts, _, _ = _adam(ctx["jstate"].opt_state)
    assert set(counts) == {0}
    assert all(int(c) == 0 for c in ctx["tstate"].opt_state["count"].values())
    jp = _jparams(ctx["jstate"])
    for k, v in tstep.named_params(ctx["tstate"]).items():
        assert torch.equal(v, before[k]), k
        np.testing.assert_array_equal(v.detach().numpy(), jp[k])
        assert not ctx["tstate"].opt_state["mu"][k].any()
        assert not ctx["tstate"].opt_state["nu"][k].any()


@pytest.mark.parametrize("lr,eta_min,grid_lr", [(5e-4, 5e-6, 0.0), (1e-3, 0.0, 2e-2)])
def test_cosine_lr_past_t_max_matches_optax(lr, eta_min, grid_lr):
    """Count by count up to 3 T_max: equal to optax's schedule, held at
    eta_min past T_max (CosineAnnealingLR would rise again); the grid group's
    schedule scales eta_min with grid_lr."""
    T = 7
    sp = {"T_max": T, "eta_min": eta_min}
    ttx = tstep.make_optimizer(lr, "cosine", sp, grid_lr=grid_lr)
    ref = jstep.make_lr_schedule("cosine", lr, sp)
    for c in range(3 * T + 1):
        np.testing.assert_allclose(float(ttx.lr("mlp", c)), float(ref(c)), rtol=1e-6)
    assert float(ttx.lr("mlp", 3 * T)) == pytest.approx(eta_min, rel=1e-6, abs=1e-12)
    if grid_lr:
        gsp = {"T_max": T, "eta_min": eta_min * grid_lr / lr}
        gref = jstep.make_lr_schedule("cosine", grid_lr, gsp)
        for c in (0, 3, T, 2 * T):
            np.testing.assert_allclose(float(ttx.lr("grid", c)), float(gref(c)),
                                       rtol=1e-6)
    assert tstep.make_lr_schedule("none", lr, {}) == lr


def test_own_draws_train():
    """Without injected draws the step draws from its generator: ten steps of
    the vanilla recipe (fp32) stay finite and lower the loss."""
    ctx = _setup("vanilla")
    losses = []
    ts = ctx["tstate"]
    for _ in range(10):
        ts, m = ctx["tfn"](ts, T_SCENE)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses)) and int(ts.step) == 10
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_unported_options_raise():
    cfg = NeRFConfig(63, 27, n_layers=3, hidden_dim=32, skip_pos=1)
    for kw, item in ((dict(sampling_mode="occupancy"), "P7 item 3"),
                     (dict(sampling_mode="proposal"), "P7 item 4"),
                     (dict(app_dim=4), "P7 item 7"),
                     (dict(pose_opt=True), "P7 item 9"),
                     (dict(barf_anneal_steps=10), "P7 item 9"),
                     (dict(pos_encoder="hashgrid"), "P7 item 8"),
                     (dict(dir_encoder="sh"), "P7 item 6")):
        with pytest.raises(NotImplementedError, match=item):
            tstep.check_ported_hyper(tstep.TrainHyper(model=cfg, **kw))
    with pytest.raises(NotImplementedError, match="P7 item 9"):
        tstep.make_optimizer(LR, pose_lr=1e-3)
