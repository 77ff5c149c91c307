"""The NeRF training step, in PyTorch autograd.

Port of ``nerf_sandbox_tpu/train/step.py:build_train_step`` (reference
``nerf_sandbox/source/train/trainer.py:876-1178``): a ray batch
(``data/sampler.py``) → stratified, jittered coarse samples → the coarse
forward (with sigma noise) → inverse-CDF fine samples from the detached
interval weights (+1e-5) → the sorted merge → the fine forward →
``MSE(coarse) + MSE(fine)`` plus the regularisers (the distortion loss on
the fine weights, riding in the coarse term so that the fine term stays the
PSNR's pure MSE; the k-planes TV outside the micro-chunk average) → one Adam
over both models with a cosine LR, the optax global-norm clip and the
``grid_lr`` / ``grid_weight_decay`` split → the non-finite skip.

The JAX step is one XLA program with no Pallas kernel; here it is eager
PyTorch: the MLP matmuls are ``torch.matmul`` in ``compute_dtype`` (bf16,
fp32 accumulation; TF32 off, ``device.py``), so a step launches none of the
package's hand-written kernels. ``scan_steps`` has no counterpart (it is
XLA's dispatch amortisation; CUDA graphs of the step are later work).

The optimizer is written out (:class:`Optimizer`) rather than taken from
``torch.optim``, because the JAX step's numbers depend on optax's forms:

* the schedule counts APPLIED updates, and holds at ``eta_min`` past
  ``T_max`` (``CosineAnnealingLR`` rises again there);
* on a non-finite loss the parameters AND the whole optimizer state (its
  counts included) are held back while the step counter advances, done on
  the device with ``torch.where`` (no host sync per step);
* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``clip_grad_norm_`` divides by ``norm + 1e-6``).

The state's tensors are updated in place (the JAX step donates its state
buffers the same way); :func:`build_train_step`'s ``step`` returns the state
with its new step count.

Random draws are injectable (``draws``): the pixel ids, the stratified
jitter, the coarse and fine sigma noise and ``sample_pdf``'s uniforms, so
the tests hand JAX's own draws to both sides. Without them the step draws
on its device from an explicit ``torch.Generator``.

Options not ported raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from nerf_sandbox_tpu_torch.core.sampling import (
    distortion_loss, merge_z_samples, perturb_z_samples, resample_midpoints,
    stratified_samples)
from nerf_sandbox_tpu_torch.data.sampler import (
    RayBatchSpec, SceneArrays, check_spec, draw_pixels, sample_ray_batch)
from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.forward import (
    check_ported_forward, nerf_forward_pass)
from nerf_sandbox_tpu_torch.models.kplanes import kplanes_tv
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP

DRAW_KEYS = ("fids", "ys", "xs", "u_strat", "noise_c", "u_pdf", "noise_f")


class TrainHyper(NamedTuple):
    """The JAX package's training hyper-parameters that are ported (same
    names and defaults), and the switches of those that are not, which must
    keep their defaults (:func:`check_ported_hyper`)."""

    model: NeRFConfig
    nc: int = 64
    nf: int = 128
    det_fine: bool = False
    raw_noise_std: float = 1.0
    sigma_activation: str = "relu"
    white_bkgd: bool = True
    infinite_last_bin: bool = True
    samp_near: float = 2.0
    samp_far: float = 6.0
    micro_chunks: int = 0          # > 1: gradient accumulation over equal slices
    pos_include_input: bool = True
    dir_include_input: bool = True
    compute_dtype: str = "bfloat16"   # MLP matmul type
    pos_encoder: str = "freq"         # "freq" | "kplanes" ("hashgrid": P7 item 8)
    enc_cfg: Any = None               # KPlanesConfig
    sampling_mode: str = "hierarchical"  # ("occupancy": P7 item 3, "proposal": item 4)
    scene_contraction: bool = False
    distortion_weight: float = 0.0
    distortion_anneal_steps: int = 0
    lindisp: bool = False
    kp_tv_weight: float = 0.0
    ipe: bool = False
    app_dim: int = 0                  # P7 item 7
    dir_encoder: str = "freq"         # ("sh": P7 item 6)
    pose_opt: bool = False            # P7 item 9
    barf_anneal_steps: int = 0        # P7 item 9


def check_ported_hyper(hyper: TrainHyper) -> None:
    """Raise for the training options this package does not port yet."""
    if hyper.sampling_mode != "hierarchical":
        item = {"occupancy": "P7 item 3", "proposal": "P7 item 4"}.get(
            hyper.sampling_mode, "P7")
        raise NotImplementedError(
            f"sampling_mode={hyper.sampling_mode!r} is ROADMAP queue 1, {item}")
    if hyper.app_dim or hyper.model.app_dim:
        raise NotImplementedError(
            "appearance codes (app_dim > 0) are ROADMAP queue 1, P7 item 7")
    if hyper.pose_opt or hyper.barf_anneal_steps > 0:
        raise NotImplementedError(
            "camera refinement (pose_opt, barf_anneal_steps) is ROADMAP "
            "queue 1, P7 item 9")
    check_ported_forward(pos_encoder=hyper.pos_encoder, ipe=hyper.ipe,
                         dir_encoder=hyper.dir_encoder)


class TrainState(NamedTuple):
    step: torch.Tensor             # int32 scalar on the device: completed steps
    model_c: NeRFMLP
    model_f: NeRFMLP
    opt_state: dict


def mse2psnr(mse):
    """trainer.py:77-78."""
    return -10.0 * torch.log10(torch.clamp(torch.as_tensor(mse), min=1e-10))


def make_lr_schedule(name: str, lr: float, params: dict):
    """The learning rate as a function of the count of applied updates, or a
    constant. Cosine is ``optax.cosine_decay_schedule(lr, T_max,
    alpha=eta_min/lr)`` (JAX step.py:155-167): ``eta_min + (lr - eta_min)
    (1 + cos(pi min(k, T_max) / T_max)) / 2``, held at ``eta_min`` past
    ``T_max``."""
    name = (name or "none").lower()
    if name in ("none", "constant"):
        return lr
    if name == "cosine":
        T_max = int(params.get("T_max"))
        if T_max <= 0:
            raise ValueError(f"cosine schedule needs T_max > 0, got {T_max}")
        alpha = float(params.get("eta_min", 0.0)) / lr if lr else 0.0

        def schedule(count):
            k = torch.clamp(torch.as_tensor(count).to(torch.float32), max=float(T_max))
            cosine = 0.5 * (1.0 + torch.cos(math.pi * k / float(T_max)))
            return lr * ((1.0 - alpha) * cosine + alpha)
        return schedule
    raise ValueError(f"unknown lr scheduler '{name}'")


class Optimizer:
    """One Adam over both models (optax.adam: b1 0.9, b2 0.999, eps 1e-8),
    with optax's global-norm clip before it; ``grid_lr`` / ``grid_weight_decay``
    give the grid tables (parameters under ``pos_grid``) an Adam of their own
    (learning rate ``grid_lr`` under the same schedule shape, ``eta_min``
    scaled alike) and a decoupled decay toward ``grid_decay_target`` after
    Adam (JAX step.py:188-252). Parameters and state are dicts of tensors
    keyed by name; the state holds ``count`` per group (the applied updates,
    which index the schedule) and ``mu`` / ``nu`` per parameter."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, scheduler: str = "cosine",
                 scheduler_params: dict | None = None,
                 grad_clip_norm: float = 0.0, grid_lr: float = 0.0,
                 grid_weight_decay: float = 0.0, grid_decay_target: float = 0.0,
                 pose_lr: float = 0.0):
        if pose_lr and pose_lr > 0:
            raise NotImplementedError(
                "camera refinement (pose_lr) is ROADMAP queue 1, P7 item 9")
        sp = dict(scheduler_params or {})
        self.schedules = {"mlp": make_lr_schedule(scheduler, lr, sp)}
        self.split = bool((grid_lr and grid_lr > 0)
                          or (grid_weight_decay and grid_weight_decay > 0))
        if self.split:
            if grid_lr and grid_lr > 0:
                gp = dict(sp)
                if "eta_min" in gp and lr:
                    gp["eta_min"] = float(gp["eta_min"]) * grid_lr / lr
                self.schedules["grid"] = make_lr_schedule(scheduler, grid_lr, gp)
            else:
                self.schedules["grid"] = self.schedules["mlp"]
        self.grad_clip_norm = float(grad_clip_norm or 0.0)
        self.grid_weight_decay = float(grid_weight_decay or 0.0)
        self.grid_decay_target = float(grid_decay_target)

    def group(self, name: str) -> str:
        return "grid" if self.split and "pos_grid" in name.split(".") else "mlp"

    def lr(self, group: str, count) -> torch.Tensor:
        """The learning rate the next update of ``group`` takes."""
        schedule = self.schedules[group]
        return torch.as_tensor(schedule(count) if callable(schedule) else schedule)

    def init(self, params: dict) -> dict:
        dev = next(iter(params.values())).device
        return {"count": {g: torch.zeros((), dtype=torch.int32, device=dev)
                          for g in self.schedules},
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: dict, state: dict, params: dict):
        """→ (updates, new state): the optax chain, without touching
        ``state``."""
        if self.grad_clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = norm < self.grad_clip_norm
            grads = {k: torch.where(keep, g, (g / norm) * self.grad_clip_norm)
                     for k, g in grads.items()}
        count = {g: c + 1 for g, c in state["count"].items()}
        scale = {g: -self.lr(g, state["count"][g]).to(c.device, torch.float32)
                 for g, c in state["count"].items()}
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            grp = self.group(k)
            mu[k] = (1.0 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state["nu"][k]
            c = count[grp].to(torch.float32)
            mu_hat = mu[k] / (1.0 - self.b1 ** c)
            nu_hat = nu[k] / (1.0 - self.b2 ** c)
            u = scale[grp] * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
            if grp == "grid" and self.grid_weight_decay > 0:
                u = u - self.grid_weight_decay * (params[k] - self.grid_decay_target)
            updates[k] = u
        return updates, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr: float, scheduler: str = "cosine",
                   scheduler_params: dict | None = None, grad_clip_norm: float = 0.0,
                   grid_lr: float = 0.0, grid_weight_decay: float = 0.0,
                   grid_decay_target: float = 0.0, pose_lr: float = 0.0) -> Optimizer:
    """JAX ``make_optimizer`` (step.py:188-252) → :class:`Optimizer`."""
    return Optimizer(lr, scheduler, scheduler_params, grad_clip_norm, grid_lr,
                     grid_weight_decay, grid_decay_target, pose_lr)


def named_params(state_or_models) -> dict:
    """{"c.<name>" / "f.<name>": parameter} of both models."""
    model_c, model_f = (state_or_models[1:3] if isinstance(state_or_models, TrainState)
                        else state_or_models)
    out = {f"c.{k}": p for k, p in model_c.named_parameters()}
    out.update({f"f.{k}": p for k, p in model_f.named_parameters()})
    return out


def init_train_state(hyper: TrainHyper, tx: Optimizer, *, near: float, far: float,
                     generator: torch.Generator | None = None,
                     initial_acc_opacity: float | None = None,
                     params: tuple | None = None, device=None) -> TrainState:
    """Both models and the optimizer state on ``device`` (``cuda`` unless
    ``"cpu"``), at step 0. The weights come from ``generator`` (a CPU
    generator, seed 0 when none is given; coarse model first), with the
    distributions of JAX ``init_nerf_params``; or, with ``params`` = (coarse,
    fine) state dicts (``models/mlp.py:params_from_jax`` of a JAX state's
    ``params_c`` / ``params_f``), are loaded."""
    check_ported_hyper(hyper)
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    grid_cfg = hyper.enc_cfg if hyper.pos_encoder == "kplanes" else None

    def model():
        return NeRFMLP(hyper.model, generator=g, near=near, far=far,
                       initial_acc_opacity=initial_acc_opacity,
                       sigma_activation=hyper.sigma_activation,
                       grid_cfg=grid_cfg, device=dev)

    model_c, model_f = model(), model()
    if params is not None:
        for m, sd in zip((model_c, model_f), params):
            m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    opt_state = tx.init(named_params((model_c, model_f)))
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), model_c,
                      model_f, opt_state)


def make_draws(hyper: TrainHyper, spec: RayBatchSpec, scene: SceneArrays, step,
               generator: torch.Generator) -> dict:
    """Every random number of one step, drawn on the scene's device:
    ``fids``, ``ys``, ``xs`` (B,) (``data/sampler.py:draw_pixels``),
    ``u_strat`` (B, nc) uniform jitter, ``noise_c`` (B, nc) and ``noise_f``
    (B, nc + nf) standard-normal sigma noise, ``u_pdf`` (B, nf) uniform
    ``sample_pdf`` draws. A micro-chunked step slices every array by rows."""
    B, dev = spec.rays_per_batch, scene.device
    d = draw_pixels(step, scene, spec, generator)

    def rand(n):
        return torch.rand((B, n), generator=generator, device=dev)

    def randn(n):
        return torch.randn((B, n), generator=generator, device=dev)

    d.update(u_strat=rand(hyper.nc), noise_c=randn(hyper.nc), u_pdf=rand(hyper.nf),
             noise_f=randn(hyper.nc + hyper.nf))
    return d


def _coarse_fine_losses(model_c, model_f, batch, draws, hyper: TrainHyper,
                        pos_bands, dir_bands, dist_scale=None):
    """Coarse + fine forward and each model's MSE for one ray (sub-)batch
    (JAX step.py:455-512). The pre-scaled distortion term rides in the
    first, so that ``loss_f`` stays pure MSE."""
    B = batch["rgb"].shape[0]
    dev = batch["rgb"].device
    z_tmpl = stratified_samples(hyper.samp_near, hyper.samp_far, hyper.nc,
                                lindisp=hyper.lindisp, device=dev)
    zc = perturb_z_samples(z_tmpl.expand(B, hyper.nc), u=draws["u_strat"])
    compute = {"float32": torch.float32, "bfloat16": torch.bfloat16}[hyper.compute_dtype]

    def fwd(model, z, noise):
        return nerf_forward_pass(
            model, batch["rays_o_marching"], batch["rays_d_marching_unit"], z,
            pos_bands=pos_bands, dir_bands=dir_bands,
            pos_include_input=hyper.pos_include_input,
            dir_include_input=hyper.dir_include_input,
            white_bkgd=hyper.white_bkgd, ray_norms=batch["rays_d_marching_norm"],
            viewdirs_world_unit=batch["rays_d_world_unit"],
            sigma_activation=hyper.sigma_activation,
            raw_noise_std=hyper.raw_noise_std, noise=noise,
            infinite_last_bin=hyper.infinite_last_bin, compute_dtype=compute,
            pos_encoder=hyper.pos_encoder, enc_cfg=hyper.enc_cfg,
            scene_contraction=hyper.scene_contraction, ipe=hyper.ipe,
            radii=batch["radii"], dir_encoder=hyper.dir_encoder, t=batch["t"],
            device=dev)

    comp_c, w_c, _, _ = fwd(model_c, zc, draws.get("noise_c"))
    # fine samples from the detached interval weights (trainer.py:926-934)
    zf = resample_midpoints(zc, w_c, hyper.nf, deterministic=hyper.det_fine,
                            u=None if hyper.det_fine else draws["u_pdf"])
    z_all = merge_z_samples(zc, zf.detach())
    comp_f, w_f, _, _ = fwd(model_f, z_all, draws.get("noise_f"))

    target = torch.clamp(torch.nan_to_num(batch["rgb"]), 0.0, 1.0)
    loss_c = torch.mean((comp_c - target) ** 2)
    loss_f = torch.mean((comp_f - target) ** 2)
    if hyper.distortion_weight > 0:
        dist = hyper.distortion_weight * distortion_loss(
            z_all, w_f, hyper.samp_near, hyper.samp_far, lindisp=hyper.lindisp)
        loss_c = loss_c + (dist * dist_scale if dist_scale is not None else dist)
    return loss_c, loss_f


def build_train_step(hyper: TrainHyper, spec: RayBatchSpec, tx: Optimizer,
                     pos_bands, dir_bands, *, generator: torch.Generator | None = None,
                     base_seed: int = 42, device=None):
    """→ ``step(state, scene, draws=None) -> (state, metrics)``, one
    optimizer step (JAX step.py:515-749 with ``scan_steps`` 0).

    ``draws`` (:data:`DRAW_KEYS`, arrays or tensors; see :func:`make_draws`)
    are used as given; without them the step draws them from ``generator``
    (a ``torch.Generator`` on ``device``, seeded with ``base_seed`` when none
    is given). ``metrics`` are tensors on the device (``loss``, ``psnr``,
    ``mse_f``, ``finite``, ``skipped``): reading them is the caller's sync.
    Runs on ``cuda`` unless ``device="cpu"``; the state and the scene must
    be there. ``step.loss_and_grads(state, scene, draws)`` is the same step's
    loss and gradients without the update."""
    check_ported_hyper(hyper)
    check_spec(spec)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(base_seed)
    m = hyper.micro_chunks if hyper.micro_chunks and hyper.micro_chunks > 1 else 1
    if spec.rays_per_batch % m:
        raise ValueError(f"batch {spec.rays_per_batch} not divisible by "
                         f"micro_chunks {m}")

    def grid_reg(model_c, model_f):
        """The tables' TV, once per step (outside the chunk average)."""
        if hyper.kp_tv_weight <= 0 or hyper.pos_encoder != "kplanes":
            return None
        return hyper.kp_tv_weight * (kplanes_tv(model_f.pos_grid)
                                     + kplanes_tv(model_c.pos_grid))

    def dist_scale_of(step):
        if hyper.distortion_weight <= 0 or not hyper.distortion_anneal_steps:
            return None
        return torch.clamp(step.to(torch.float32) / hyper.distortion_anneal_steps,
                           0.0, 1.0)

    def loss_and_grads(state: TrainState, scene: SceneArrays, draws=None):
        """The step's loss, fine MSE and gradients {name: tensor} (before the
        clip), without the update → (loss, mse_f, grads, step)."""
        for t in (state.step, scene.images):
            if t.device.type != dev.type:
                raise ValueError(f"state and scene must be on {dev}, got {t.device}")
        step = state.step + 1                        # 1-based, like the loop
        if draws is None:
            draws = make_draws(hyper, spec, scene, step, generator)
        draws = {k: torch.as_tensor(np.array(draws[k]) if isinstance(draws[k], np.ndarray)
                                    else draws[k]).to(dev)
                 for k in DRAW_KEYS if k in draws}
        batch = sample_ray_batch(step, scene, spec, fids=draws["fids"],
                                 ys=draws["ys"], xs=draws["xs"], device=dev)
        params = named_params(state)
        leaves = list(params.values())
        dscale = dist_scale_of(step)
        B = spec.rays_per_batch
        grads = [torch.zeros_like(p) for p in leaves]
        loss = torch.zeros((), device=dev)
        mse_f = torch.zeros((), device=dev)

        def accumulate(value):
            for acc, gr in zip(grads, torch.autograd.grad(value, leaves,
                                                          allow_unused=True)):
                if gr is not None:
                    acc += gr

        for i in range(m):
            rows = slice(i * (B // m), (i + 1) * (B // m))
            lc, lf = _coarse_fine_losses(
                state.model_c, state.model_f, {k: v[rows] for k, v in batch.items()},
                {k: v[rows] for k, v in draws.items()}, hyper, pos_bands, dir_bands,
                dscale)
            total = (lc + lf) / m
            accumulate(total)
            loss = loss + total.detach()
            mse_f = mse_f + lf.detach() / m
        reg = grid_reg(state.model_c, state.model_f)
        if reg is not None:
            accumulate(reg)
            loss = loss + reg.detach()
        return loss, mse_f, dict(zip(params, grads)), step

    def step_fn(state: TrainState, scene: SceneArrays, draws=None):
        loss, mse_f, grads, step = loss_and_grads(state, scene, draws)
        params = named_params(state)
        # non-finite loss → skip the update, hold the optimizer state, count
        # the step (JAX step.py:707-729; trainer.py:713-716)
        finite = torch.isfinite(loss)
        grads = {k: torch.where(finite, g, torch.zeros_like(g)) for k, g in grads.items()}
        with torch.no_grad():
            updates, new_opt = tx.update(grads, state.opt_state, params)
            for group in ("mu", "nu"):
                for k, old in state.opt_state[group].items():
                    old.copy_(torch.where(finite, new_opt[group][k], old))
            for g, old in state.opt_state["count"].items():
                old.copy_(torch.where(finite, new_opt["count"][g], old))
            for k, p in params.items():
                p.copy_(torch.where(finite, p + updates[k], p))
        metrics = {"loss": loss, "psnr": mse2psnr(mse_f), "mse_f": mse_f,
                   "finite": finite, "skipped": (~finite).to(torch.int32)}
        return state._replace(step=step), metrics

    step_fn.loss_and_grads = loss_and_grads
    return step_fn
