"""Runs one cell of the benchmark against ``nerf_sandbox_tpu_torch``.

A run: the scene (written once per checkout), the program's ``Trainer`` built
from the configuration's flags through the CLI's ``resolve_config``, the
weights made from ``--seed`` on the card and loaded into it, the cell's
warm-up (set-up ends there), the measured window, then the correctness check
against the plain reference (``reference/``), run once the window has closed,
the peak memory has been read and the program's state is freed.

Two loops, chosen by the traffic file's ``kind``:

* ``train``: closed-loop chunks of ``scan_steps`` optimizer steps (the
  program's captured chunk, ``train/step.py:build_train_step``), each fed
  ``scan_steps`` sets of draws (pixels, jitter, noise, inverse-CDF uniforms)
  made from the seed; one chunk in flight. Under several ranks (the
  traffic's ``mesh_devices``) every rank runs the same chunks, and they agree
  after each chunk on whether the window has ended.
* ``render``: 800x800 frames along the Blender camera path through the
  trainer's eval models and tile renderer (``render/renderer.py:render_pose``),
  one after another; a frame counts once its rgb, depth and opacity are on
  the host.

Nothing here imports the program at module level: the run checks for the
card first.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time

import numpy as np
import torch

from port_bench import arith, check, scene as scene_mod
from port_bench.reference import nerf as ref
from port_bench.trace import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_sandbox_tpu")
WINDOW_SPAN = "port_bench.window"
# seeds of the run's streams, offsets from --seed
DRAW_STREAM = 1 << 40
PIXEL_STREAM = 1 << 41
# the first steps the reference follows one by one, before the first chunk
CHECKED_STEPS = 3
# the chunks after them that the reference follows: the capture, then a replay
CHECKED_CHUNKS = 2


def process_age_s() -> float:
    """Seconds since this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


def mark(what: str) -> None:
    """A line on standard error: how far into the process a set-up stage
    ended."""
    print(f"[port_bench] {what}: {process_age_s():.2f} s", file=sys.stderr)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    """A process of the run (this one or a rank) loaded JAX or the JAX
    package; ``names`` are their top-level names."""

    def __init__(self, names: list):
        super().__init__(f"modules of JAX or the JAX package were loaded: {names}")
        self.names = names


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scene_params(cell: dict) -> dict:
    return {**scene_mod.PARAMS, **cell["traffic"].get("scene", {})}


# ---------------------------------------------------------------- inputs

class Feed:
    """Each optimizer step's draws, from the seed, on the device: the global
    batch's frame ids and pixels, the coarse jitter, the coarse and fine
    density noise, and the inverse-CDF uniforms."""

    def __init__(self, seed: int, st: dict, n_frames: int, H: int, W: int, dev):
        self.g = torch.Generator(device=dev)
        self.g.manual_seed((int(seed) + DRAW_STREAM) % (1 << 63))
        self.B, self.nc, self.nf = int(st["rays_per_batch"]), int(st["nc"]), int(st["nf"])
        self.n_frames, self.H, self.W, self.dev = n_frames, H, W, dev

    def step(self) -> dict:
        g, B, dev = self.g, self.B, self.dev

        def ints(hi):
            return torch.randint(0, hi, (B,), generator=g, device=dev)

        def rand(n):
            return torch.rand((B, n), generator=g, device=dev)

        def randn(n):
            return torch.randn((B, n), generator=g, device=dev)

        return {"fids": ints(self.n_frames), "ys": ints(self.H), "xs": ints(self.W),
                "u_strat": rand(self.nc), "noise_c": randn(self.nc),
                "u_pdf": rand(self.nf), "noise_f": randn(self.nc + self.nf)}


def cell_paths(cell: dict) -> tuple:
    """(the scene's directory, written first if need be; the program's
    ``--out_dir``) of ``cell``, both under this checkout's cache."""
    root = scene_mod.ensure(scene_params(cell))
    mark("scene")
    return str(root), str(scene_mod.CACHE / "out" / cell["workload"]["name"])


def make_trainer(cell: dict, seed: int, dev, paths: tuple):
    """The program's Trainer from the configuration's flags (the CLI's
    ``resolve_config``) on the scene and out dir ``paths``, with the
    benchmark's weights from ``seed`` loaded into its state."""
    from nerf_sandbox_tpu_torch.scripts.train_nerf import resolve_config
    from nerf_sandbox_tpu_torch.train.trainer import Trainer
    from port_bench.cells import argv_of
    argv = argv_of(cell["flags"]) + ["--data_root", paths[0], "--out_dir", paths[1],
                                     "--seed", str(int(seed) % (1 << 31))]
    with contextlib.redirect_stdout(sys.stderr):
        trainer = Trainer(resolve_config(argv), device=dev)
    mark("trainer")
    load_weights(trainer.state, ref.init_params(ref.settings(cell["flags"]), seed, dev))
    return trainer


def load_weights(state, weights: dict) -> None:
    """Copy ``weights`` into the program's parameters, in place, and start
    its optimizer afresh (zero moments and counts, step 0)."""
    from nerf_sandbox_tpu_torch.train.step import named_params
    prog = named_params(state)
    if set(prog) != set(weights):
        raise ValueError(f"the program's parameters {sorted(set(prog) ^ set(weights))} "
                         "differ from the configuration's")
    with torch.no_grad():
        for name, t in prog.items():
            if tuple(t.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's shape {tuple(t.shape)} is not "
                                 f"the configuration's {tuple(weights[name].shape)}")
            t.copy_(weights[name])
        for group in ("mu", "nu"):
            for t in state.opt_state[group].values():
                t.zero_()
        for t in state.opt_state["count"].values():
            t.zero_()
        state.step.zero_()


# ---------------------------------------------------------------- window

class Window:
    """The measured window: the loop's iterations, one in flight, until
    ``seconds`` have passed on the host clock, under the profiler when
    traced. ``run(step)`` → (iterations, seconds to the last one's end, the
    profiler or None); ``agree(stop)`` is how several ranks end together."""

    def __init__(self, dev, seconds: float, trace: bool, agree=None):
        self.dev, self.seconds, self.trace = dev, seconds, trace
        self.agree = agree or (lambda stop: stop)

    def run(self, step):
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        sync(self.dev)
        n, prev = 0, None
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            while True:
                with torch.profiler.record_function("port_bench.iteration"):
                    step()
                n += 1
                if self.dev.type == "cuda":           # one iteration in flight
                    ev = torch.cuda.Event()
                    ev.record()
                    if prev is not None:
                        prev.synchronize()
                    prev = ev
                if self.agree(time.perf_counter() - t0 >= self.seconds):
                    break
            sync(self.dev)
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
        return n, t1 - t0, prof


# ---------------------------------------------------------------- training

def rank_device(device=None) -> torch.device:
    return torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())


def train_setup(cell, seed: int, paths: tuple, device=None) -> tuple:
    """The program's training path on this rank: (cell, device, the
    captured chunk's function, the state, the scene's arrays). ``cell``: a
    spawned rank gets its ``where`` and finds the cell anew."""
    from nerf_sandbox_tpu_torch.train.step import build_train_step
    if isinstance(cell, tuple):
        from port_bench.cells import find_cell
        cell = find_cell(*cell)
    dev = rank_device(device)
    trainer = make_trainer(cell, seed, dev, paths)
    chunk = build_train_step(trainer.hyper, trainer.spec, trainer.tx, trainer.pos_bands,
                             trainer.dir_bands, base_seed=int(seed) % (1 << 31),
                             scan_steps=int(cell["traffic"]["scan_steps"]),
                             plan=trainer.plan, device=dev)
    return cell, dev, chunk, trainer.state, trainer.scene_arrays


def train_rank(cell, seed: int, seconds: float, trace: bool, t_start: float,
               paths: tuple, device=None) -> dict:
    """One rank of a training cell: set-up, the checked first steps, the
    window. → this rank's readings, counts and trace metrics."""
    from nerf_sandbox_tpu_torch.parallel import dist
    cell, dev, chunk, state, scene = train_setup(cell, seed, paths, device)
    rank = dist.rank()
    st = ref.settings(cell["flags"])
    sp = scene_params(cell)
    k = int(cell["traffic"]["scan_steps"])
    feed = Feed(seed, st, sp["views"], sp["height"], sp["width"], dev)
    readings = first_steps(chunk, state, scene, feed, k)
    state = readings.pop("state")     # its last chunk replayed the capture: warm
    sync(dev)
    setup_s = time.time() - t_start
    mark("set-up: checked steps, capture and replay")
    skipped = []

    def one_chunk():
        nonlocal state
        with torch.profiler.record_function("port_bench.draws"):
            draws = [feed.step() for _ in range(k)]
        with torch.profiler.record_function("port_bench.chunk"):
            state, m = chunk(state, scene, draws=draws)
        skipped.append(m["skipped"].clone())

    agree = None
    if dist.world_size() > 1:
        dist.barrier()

        def agree(stop):
            return dist.agree_flags([stop])[0] > 0
    window_s = seconds if not trace else min(seconds, float(cell["traffic"]["trace_seconds"]))
    chunks, elapsed, prof = Window(dev, window_s, trace, agree).run(one_chunk)
    skipped = int(torch.stack(skipped).sum()) if skipped else 0
    out = {"rank": rank, "readings": readings, "chunks": chunks, "elapsed": elapsed,
           "steps": chunks * k, "skipped": skipped, "setup_s": setup_s,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0),
           "loaded": forbidden_modules()}
    if prof is not None:
        out["trace"] = trace_summary(cell, prof, dev, {"steps": chunks * k,
                                                       "world": dist.world_size()})
    del state, chunk, scene, feed, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def first_steps(chunk, state, scene, feed, k: int) -> dict:
    """The run's first steps, through the window's own step and feed:
    ``CHECKED_STEPS`` single steps of the chunk's step function, then
    ``CHECKED_CHUNKS`` chunks of ``k``: the first captures the chunk on the
    card, the others replay it on fresh draws, as every chunk of the window
    does. → the program's readings: each single step's loss and each
    chunk's mean and last, the first gradient from Adam's first moment and
    its norm per leaf, and the change's norm per leaf over the single steps
    and over each chunk; the parameters each single step after the first
    started from (``states``); and ``state``. Arrays are numpy on the host,
    so that a spawned rank hands them back by value."""
    from nerf_sandbox_tpu_torch.train.step import named_params
    params = named_params(state)
    before = {n: t.detach().clone() for n, t in params.items()}
    losses, grad1, states = [], None, []
    for i in range(CHECKED_STEPS):
        if i:
            states.append({n: t.detach().cpu().numpy().copy() for n, t in params.items()})
        state, m = chunk.step(state, scene, draws=feed.step())
        losses.append(m["loss"].detach().clone())
        if i == 0:
            mu = state.opt_state["mu"]
            g1 = {n: mu[n] / (1.0 - ref.ADAM_B1) for n in params}
            grad1 = check.leaf_norms(g1)
            g1 = {n: t.cpu().numpy().copy() for n, t in g1.items()}
    params = named_params(state)
    start = {n: t.detach().clone() for n, t in params.items()}
    moves = [check.leaf_norms({n: start[n] - before[n] for n in params})]
    del before
    for _ in range(CHECKED_CHUNKS):
        state, m = chunk(state, scene, draws=[feed.step() for _ in range(k)])
        losses += [m["loss_mean"].clone(), m["loss"].clone()]
        params = named_params(state)
        moves.append(check.leaf_norms({n: params[n] - start[n] for n in params}))
        start = {n: t.detach().clone() for n, t in params.items()}
    del start
    losses = torch.stack(losses).cpu().tolist()
    return {"losses": losses[:CHECKED_STEPS], "chunk_losses": losses[CHECKED_STEPS:],
            "grad1": grad1, "moves": moves, "states": states, "state": state,
            "grad1_vec": g1}


def reference_steps(cell: dict, seed: int, dev, mode: str = "fp32", rows=None,
                    k: int | None = None, loss_scale: float = 1.0,
                    frozen: bool = False) -> dict:
    """The reference (or, with ``mode`` "fp8", the control; with ``rows``
    and ``loss_scale`` a fault: the loss over those rays alone, scaled;
    with ``frozen`` one that leaves the parameters as they were)
    through the same first steps from the same weights and draws →
    readings like :func:`first_steps`'."""
    st = ref.settings(cell["flags"])
    sp = scene_params(cell)
    k = int(cell["traffic"]["scan_steps"]) if k is None else k
    arrays = scene_mod.load(sp)
    scene = {n: torch.as_tensor(a, device=dev) for n, a in arrays.items()}
    feed = Feed(seed, st, sp["views"], sp["height"], sp["width"], dev)
    params = ref.init_params(st, seed, dev)
    adam = ref.new_adam(params)
    before = dict(params)
    losses, grad1, states = [], None, []
    for i in range(CHECKED_STEPS):
        if i:
            states.append(dict(params))
        out = ref.train_step(params, adam, scene, feed.step(), st, mode, rows, loss_scale,
                             frozen)
        losses.append(out["loss"])
        if i == 0:
            grad1 = check.leaf_norms(out["grads"])
            g1 = out["grads"]
    moves = [check.leaf_norms({n: params[n] - before[n] for n in params})]
    chunk_losses = []
    for _ in range(CHECKED_CHUNKS):
        start = dict(params)
        ls = [ref.train_step(params, adam, scene, feed.step(), st, mode, rows, loss_scale,
                             frozen)["loss"] for _ in range(k)]
        chunk_losses += [sum(ls) / k, ls[-1]]
        moves.append(check.leaf_norms({n: params[n] - start[n] for n in params}))
    return {"losses": losses, "chunk_losses": chunk_losses, "grad1": grad1,
            "states": states, "grad1_vec": g1, "moves": moves}


def losses_at(cell: dict, seed: int, dev, states: list) -> list:
    """The reference's loss of each single step from where the measured
    side started it: the seed's weights for the first, then ``states``, on
    the same draws. Adam's first steps turn each entry's rounding into a
    move of ±lr wherever a gradient is near 0, so two sides' own paths part
    from the second step on; the loss from one's own start is its step's
    arithmetic alone."""
    st = ref.settings(cell["flags"])
    sp = scene_params(cell)
    scene = {n: torch.as_tensor(a, device=dev) for n, a in scene_mod.load(sp).items()}
    feed = Feed(seed, st, sp["views"], sp["height"], sp["width"], dev)
    out = []
    for params in [ref.init_params(st, seed, dev)] + list(states):
        p = {n: torch.as_tensor(t, device=dev) for n, t in params.items()}
        out.append(ref.train_step(p, ref.new_adam(p), scene, feed.step(), st,
                                  frozen=True)["loss"])
    return out


def run_train(cell: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    t_start = time.time() - process_age_s()
    paths = cell_paths(cell)
    ranks = on_ranks(cell, train_rank, (seed, seconds, trace, t_start, paths), dev)
    r0 = ranks[0]
    st = ref.settings(cell["flags"])
    samples = r0["steps"] * arith.train_samples_per_step(st)
    result = {"attempted": r0["steps"], "failed": r0["skipped"],
              "loaded": sorted({m for r in ranks for m in r["loaded"]}),
              "e2e": {"train_samples_per_s": samples / r0["elapsed"],
                      "setup_s": r0["setup_s"]},
              "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks),
              "trace": r0.get("trace")}
    ref.strict_fp32()
    expect = reference_steps(cell, seed, dev)
    numbers = {}
    for r in ranks:
        r["readings"]["own_losses"] = losses_at(cell, seed, dev, r["readings"]["states"])
        for name, v in check.train_numbers(r["readings"], expect).items():
            numbers[name] = max(numbers.get(name, 0.0), v)
    result["numbers"] = numbers
    return result


def on_ranks(cell: dict, fn, args: tuple, dev) -> list:
    """``fn(cell, *args, device=...)`` on each rank the cell asks for
    (``mesh_devices``): in this process for one, else on ranks spawned by
    the program's own launcher (``parallel/dist.py:run_ranks``), each given
    the cell's ``where`` → each rank's result, in rank order."""
    world = int(cell["flags"].get("mesh_devices", 1) or 1)
    if world <= 1:
        return [fn(cell, *args, device=dev)]
    from nerf_sandbox_tpu_torch.parallel.dist import run_ranks
    from nerf_sandbox_tpu_torch.scripts.train_nerf import resolve_config
    from port_bench.cells import argv_of
    cfg = resolve_config(argv_of(cell["flags"]) + ["--data_root", ".", "--out_dir", "."])
    return run_ranks(fn, (cell["where"], *args), cfg, summary=_identity,
                     device=None if dev.type == "cuda" else "cpu")


def _identity(x):
    return x


# ---------------------------------------------------------------- rendering

def path_poses(n: int, radius: float, phi_deg: float = -30.0,
               theta_start_deg: float = -180.0) -> np.ndarray:
    """The Blender render path (bmild/nerf's ``pose_spherical``): ``n``
    cameras on a circle at elevation ``phi`` around the origin → (n, 3, 4)."""
    out = []
    for theta in np.linspace(theta_start_deg, theta_start_deg + 360.0, n, endpoint=False):
        t = np.eye(4)
        t[2, 3] = radius
        phi, th = np.deg2rad(phi_deg), np.deg2rad(theta)
        rphi = np.eye(4)
        rphi[1, 1] = rphi[2, 2] = np.cos(phi)
        rphi[1, 2], rphi[2, 1] = -np.sin(phi), np.sin(phi)
        rth = np.eye(4)
        rth[0, 0] = rth[2, 2] = np.cos(th)
        rth[0, 2], rth[2, 0] = -np.sin(th), np.sin(th)
        axes = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], float)
        out.append((axes @ rth @ rphi @ t)[:3])
    return np.asarray(out, np.float32)


def render_one(tile, model_c, model_f, poses, i: int, K, chunk: int, sp: dict, dev,
               rng, S: int) -> tuple:
    """Frame ``i`` of the path through the program's ``render_pose`` →
    (pose index, ``S`` pixel indices drawn from ``rng``, {rgb, acc, depth}
    at those pixels, on the host)."""
    from nerf_sandbox_tpu_torch.render.renderer import render_pose
    H, W = sp["height"], sp["width"]
    with torch.profiler.record_function("port_bench.frame"):
        out = render_pose(tile, model_c, model_f, poses[i % len(poses)], H, W, K,
                          eval_chunk=chunk, convention="opengl", device=dev)
    idx = rng.integers(0, H * W, S)
    return (i % len(poses), idx, {n: torch.from_numpy(out[n].reshape(H * W, -1)[idx].copy())
                                  for n in ("rgb", "acc", "depth")})


def run_render(cell: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    from nerf_sandbox_tpu_torch.render.renderer import render_pose
    t_start = time.time() - process_age_s()
    sp = scene_params(cell)
    tr = cell["traffic"]
    H, W = sp["height"], sp["width"]
    K = scene_mod.intrinsics(sp)
    poses = path_poses(int(tr["path_frames"]), sp["radius"])
    trainer = make_trainer(cell, seed, dev, cell_paths(cell))
    model_c, model_f = trainer.eval_models()
    tile, chunk = trainer.render_tile, int(cell["flags"]["eval_chunk"])
    del trainer
    rng = np.random.default_rng((int(seed) + PIXEL_STREAM) % (1 << 63))
    S = int(tr["check_pixels"])
    frames = []

    def frame():
        frames.append(render_one(tile, model_c, model_f, poses, len(frames), K, chunk,
                                 sp, dev, rng, S))

    render_pose(tile, model_c, model_f, poses[0], H, W, K, eval_chunk=chunk,
                convention="opengl", device=dev)          # warm-up: the kernels' first use
    sync(dev)
    setup_s = time.time() - t_start
    mark("set-up")
    window_s = seconds if not trace else min(seconds, float(tr["trace_seconds"]))
    n, elapsed, prof = Window(dev, window_s, trace).run(frame)
    result = {"attempted": n, "failed": 0,
              "e2e": {"render_frame_s": elapsed / n, "setup_s": setup_s},
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0), "trace": None}
    if prof is not None:
        result["trace"] = trace_summary(cell, prof, dev, {"frames": n})
    del model_c, model_f, tile, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref.strict_fp32()
    expect = reference_frames(cell, seed, frames, poses, K, dev)
    own = reference_frames(cell, seed, frames, poses, K, dev, mode="bf16")
    result["numbers"] = {"frame_gap": worst_frame_gap(cell, [f[2] for f in frames], expect,
                                                      own)}
    return result


def reference_frames(cell: dict, seed: int, frames: list, poses, K, dev,
                     mode: str = "fp32", shift: int = 0) -> list:
    """The reference's render (``mode`` "fp8": the control's; "bf16": with
    the configuration's own products) of each frame's sampled pixels →
    [{rgb, acc, depth, kink}]; ``shift`` renders the pose ``shift`` places
    on (what a stale frame would show)."""
    st = ref.settings(cell["flags"])
    params = ref.init_params(st, seed, dev)
    Kt = torch.as_tensor(K, device=dev)
    W = scene_params(cell)["width"]
    out = []
    with torch.no_grad():
        for pose_i, idx, _ in frames:
            c2w = torch.as_tensor(poses[(pose_i + shift) % len(poses)], device=dev)
            idx_t = torch.as_tensor(idx, device=dev)
            rays = ref.camera_rays(Kt, c2w, idx_t % W, idx_t // W)
            coarse, fine = ref.render_rays(params, rays, st, mode)
            out.append({"rgb": fine[0], "acc": fine[2][:, None], "depth": fine[3][:, None],
                        "kink": torch.minimum(coarse[4].abs(), fine[4].abs())})
    return out


def worst_frame_gap(cell: dict, got: list, expect: list, own: list) -> float:
    """The worst frame's :func:`check.frame_gap` of ``got`` against the
    fp32 reference ``expect``, in units of ``own``'s (the bf16
    reference's)."""
    far = ref.settings(cell["flags"])["far"]
    return max(check.frame_gap({n: v.to(e["rgb"].device) for n, v in g.items()}, e, o, far)
               for g, e, o in zip(got, expect, own, strict=True))


# ---------------------------------------------------------------- trace

def trace_summary(cell: dict, prof, dev, counts: dict) -> dict:
    """The per-layer metrics this cell lists, read from the trace by their
    readers, with the device's busy time and the breakdown."""
    tr = Trace(prof, WINDOW_SPAN, device_index=dev.index or 0)
    run = {"trace": tr, "settings": ref.settings(cell["flags"]), "arith": arith,
           "scene": scene_params(cell), "counts": counts, "window_s": tr.window_s}
    metrics = {}
    for m in cell["per_layer"]:
        value = m["reader"](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"metrics": metrics, "busy_s": tr.busy_s, "window_s": tr.window_s,
            "breakdown": {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}}


KINDS = {"train": run_train, "render": run_render}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev) -> dict:
    """One run of ``cell`` (:func:`cells.find_cell`) → the result line's
    dict, ``correct`` decided by the cell's limits. Raises
    :class:`ForbiddenModules` when this process or a rank had loaded JAX
    or the JAX package by the time its window closed."""
    kind = cell["traffic"]["kind"]
    if kind not in KINDS:
        raise ValueError(f"unknown traffic kind {kind!r}: {sorted(KINDS)}")
    res = KINDS[kind](cell, seed, seconds, trace, dev)
    loaded = sorted(set(res.get("loaded", ())) | set(forbidden_modules()))
    if loaded:
        raise ForbiddenModules(loaded)
    correct, checks = check.verdict(res["numbers"], cell["limits"])
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(cell["workload"]["chips"]),
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        t = res["trace"]
        metrics = t["metrics"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {n: {"value": v, "unit": units[n]} for n, v in res["e2e"].items()
                   if n in units}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = res["trace"]["breakdown"]
    line["checks"] = checks
    return line
