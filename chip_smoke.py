#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's eval render path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA card

Phases (any failure exits non-zero):

1. device line: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel of ``nerf_sandbox_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel);
3. K1 (fused MLP) against its plain PyTorch version at 16384x64 rows with the
   reference's 8x256 weights (``tests/golden/mlp_state.npz``), max |diff|
   <= 0.05, timed with CUDA events (median of 10 after warm-up);
4. K2 (fused ray-march) against its plain version on one real eval tile
   (16384 rays x 192 merged samples of frame 1): comp, w, acc 2e-2 and depth
   0.1; early ray termination (eps 1e-4) against none within 1e-3, on the
   reference weights and on a dense variant where ERT fires; timed;
5. the slice: ``render_pose`` of two 800x800 Blender-style poses through K2
   (``EvalHyper`` vanilla, ``use_kernel=True``) and one
   ``nerf_forward_pass(use_kernel=True)`` over a fine tile through K1, with
   the launch counters zeroed just before and read just after; frames must
   be finite and in [0, 1], and frame 1 rendered through the plain path
   (``use_kernel=False``) must agree within 2e-2 and at >= 40 dB PSNR;
6. a ``{"kernels": [...]}`` JSON line with each kernel's launches on the
   main path, max |diff| against its plain version, its time, the plain
   version's time and the card's bound for the same work; then the last
   line ``{"ok": true, "device": {...}}``.

The infinite last bin makes a ray's composite a step function of the sign of
its last sigma logit (``last_bin_kink``). Rays whose logit is closer to zero
than twice the measured kernel-vs-plain logit difference are counted (at
most 5% allowed) and held on every sample but the last (phase 4) or by the
frame PSNR (phase 5); every other ray is held at the tolerances above.

There is no CPU path: without a CUDA device, or without the package beside
this script, it prints nothing on stdout and exits 2.
"""

import json
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES = 3.35e12        # HBM3 bandwidth, H100 SXM
N_POSES = 2
IMG = 800
FOCAL = 1111.1
EVAL_CHUNK = 16384


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps=10):
    """Median time of ``fn`` on the card over ``reps`` runs, after warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def mlp_macs_per_row(cfg):
    """Unpadded multiply-adds of the skip MLP per sample row (vanilla:
    593,408)."""
    from nerf_sandbox_tpu_torch.models.mlp import trunk_in_dims
    H = cfg.hidden_dim
    return (sum(d * H for d in trunk_in_dims(cfg)) + H * H + H
            + (H + cfg.enc_dir_dim) * (H // 2) + (H // 2) * 3)


def bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def last_bin_kink(pairs):
    """Rays too close to the infinite last bin's step to hold sample-exact.

    The last sample's delta is 1e10*|d|, so its alpha is a step in its sigma
    logit: 0 at or below zero, 1 above ~1e-8. Two correct implementations
    whose logits differ by rounding can fall on either side of zero there,
    and that ray's composite then differs by its whole last-bin term. For
    each (kernel, plain) pair of last-sample logits, the band is twice the
    largest |kernel - plain| measured on these very points; a ray is at the
    kink when its plain logit lies inside the band. → (mask, bands).
    """
    mask, bands = None, []
    for k, p in pairs:
        band = 2.0 * float((k - p).abs().max())
        m = p.abs() < band
        mask = m if mask is None else mask | m
        bands.append(round(band, 6))
    return mask, bands


def blender_pose(i):
    """Orbit pose i at radius 4 (bench.py:44-51)."""
    import numpy as np
    th = i * np.pi / 6
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
    return c2w


def max_diff(a, b):
    return float((a - b).abs().max())


def run(torch, root):
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.device import resolve_device
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    # ---- 1. device line ----
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    check(smi, "nvidia-smi gave no card")
    card = smi[0].strip()
    print(f"[device] {name} x{count} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s for "
          f"{sorted(report) or 'nothing (already built)'}", flush=True)
    for src, rep in report.items():
        regs = [ln.strip() for ln in rep["ptxas"].splitlines() if "registers" in ln]
        print(f"[build] {src}: {rep['seconds']:.2f} s; {'; '.join(regs)}", flush=True)

    cfg = NeRFConfig(enc_pos_dim=63, enc_dir_dim=27, n_layers=8,
                     hidden_dim=256, skip_pos=4)
    sd = np.load(os.path.join(root, "tests", "golden", "mlp_state.npz"))
    model_f = NeRFMLP(cfg, device=dev)
    model_f.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    packed_f = fm.pack_nerf_params(model_f)
    macs = mlp_macs_per_row(cfg)
    kernels = {}

    # ---- 3. K1 against its plain version ----
    rng = np.random.RandomState(0)
    Q = EVAL_CHUNK * 64
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    got = fm.fused_nerf_apply(packed_f, ep, ed)
    want = fm.fused_nerf_apply_plain(packed_f, ep, ed)
    torch.cuda.synchronize()
    err = max_diff(got, want)
    check(torch.isfinite(got).all().item(), "K1 output not finite")
    check(err <= 0.05, f"K1 max |diff| {err} > 0.05")
    ms = cuda_ms(torch, lambda: fm.fused_nerf_apply(packed_f, ep, ed))
    plain_ms = cuda_ms(torch, lambda: fm.fused_nerf_apply_plain(packed_f, ep, ed))
    b_ms, b_by = bound(2.0 * macs * Q,
                       Q * (63 + 27) * 2 + packed_f.flat.numel() * 2 + Q * 4 * 4)
    kernels["fused_mlp"] = dict(
        name="fused_mlp", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_mlp.cu",
        replaces="nerf_sandbox_tpu/ops/fused_mlp.py:162", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[K1] Q={Q} max|diff|={err:.3g} (tol 0.05) kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})", flush=True)

    # ---- 4. K2 against its plain version, on a real eval tile ----
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]],
                    np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(blender_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    sl = slice(IMG * IMG // 2, IMG * IMG // 2 + EVAL_CHUNK)   # mid-frame tile
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn, vd = rays.d_march_norm[sl].contiguous(), rays.d_world_unit[sl].contiguous()
    enc_dir = positional_encoding(vd, dir_bands)
    with torch.no_grad():
        zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(model_c, ro, rd, zc, rn, enc_dir, pos_bands)
        z = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                   deterministic=True)).contiguous()
    B, N = z.shape
    kw = dict(pos_include_input=True, sigma_activation="relu", white_bkgd=True)
    got = fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir, pos_bands)
    dt = fr._deltas(z, rn, True)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, **kw))
    torch.cuda.synchronize()
    names = ("comp", "w", "acc", "depth")
    # Rays at the last-bin kink (see last_bin_kink) are held on every sample
    # weight but the last; all other rays on every output.
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(packed_f, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(packed_f, enc_last, enc_dir)[:, 3])])
    ok = ~kink
    errs = {n: max_diff(g[ok], w[ok]) for n, g, w in zip(names, got, want)}
    errs["w[:-1]"] = max_diff(got[1][:, :-1], want[1][:, :-1])
    n_kink = int(kink.sum())
    print(f"[K2] tile {B}x{N}: max|diff| vs plain {errs}; {n_kink} rays at "
          f"the last-bin kink (|logit| < {bands[0]:.3g}), whole-tile comp "
          f"max|diff| {max_diff(got[0], want[0]):.3g}", flush=True)
    check(n_kink <= 0.05 * B, f"K2: {n_kink} of {B} rays at the last-bin kink")
    for n, tol in zip(names + ("w[:-1]",), (2e-2, 2e-2, 2e-2, 0.1, 2e-2)):
        check(np.isfinite(errs[n]) and errs[n] <= tol,
              f"K2 {n} max |diff| {errs[n]} > {tol}")
    # ERT on the tile, and on a dense variant of the model (sigma bias +10)
    # where every ray saturates and whole blocks stop early.
    model_d = NeRFMLP(cfg, device=dev)
    model_d.load_state_dict(model_f.state_dict())
    with torch.no_grad():
        model_d.sigma_out.bias += 10.0
    packed_d = fm.pack_nerf_params(model_d)
    ert_ms = {}
    for tag, pk in (("golden", packed_f), ("dense", packed_d)):
        full = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
        ert = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                ert_eps=1e-4)
        ert_errs = {n: max_diff(g, w) for n, g, w in zip(names, ert, full)}
        ert_ms[tag] = (
            cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                     pos_bands)),
            cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                     pos_bands, ert_eps=1e-4)))
        print(f"[K2] ERT(1e-4) vs none, {tag} model: max|diff| {ert_errs}; "
              f"{ert_ms[tag][0]:.3f} ms without, {ert_ms[tag][1]:.3f} ms with",
              flush=True)
        for n in names:
            check(np.isfinite(ert_errs[n]) and ert_errs[n] <= 1e-3,
                  f"K2 ERT ({tag}) {n} max |diff| {ert_errs[n]} > 1e-3")
    ms = ert_ms["golden"][0]
    plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, **kw))
    coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, ro, rd, zc, rn, enc_dir, pos_bands))
    b_ms, b_by = bound(2.0 * macs * B * N,
                       B * (7 + 27) * 4 + B * N * 4 * 3 + B * 5 * 4
                       + packed_f.flat.numel() * 2)
    kernels["fused_raymarch"] = dict(
        name="fused_raymarch", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559",
        max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[K2] fine tile kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); coarse "
          f"tile {B}x{zc.shape[1]} kernel {coarse_ms:.3f} ms", flush=True)

    # ---- 5. the slice: render_pose through K2, nerf_forward_pass through K1 ----
    hyper = EvalHyper(model=cfg, use_kernel=True)
    tile_k = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fm.fused_nerf_apply.launches = 0
    fr.fused_raymarch.launches = 0
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, blender_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK,
                                  device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, ro, rd, z, pos_bands=pos_bands,
                                dir_bands=dir_bands, white_bkgd=True,
                                ray_norms=rn, viewdirs_world_unit=vd,
                                infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                device=dev)
    torch.cuda.synchronize()
    launches = {"fused_mlp": fm.fused_nerf_apply.launches,
                "fused_raymarch": fr.fused_raymarch.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    print(f"[slice] launches on the main path: {launches} (K2 expected "
          f"{2 * n_tiles * N_POSES})", flush=True)
    check(launches["fused_raymarch"] == 2 * n_tiles * N_POSES,
          f"K2 launched {launches['fused_raymarch']} times, expected "
          f"{2 * n_tiles * N_POSES}")
    check(launches["fused_mlp"] >= 1, "K1 was not launched on the main path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"frame {k} {key} not finite")
        check(f["rgb"].shape == (IMG, IMG, 3), f"frame {k} rgb shape")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"frame {k} rgb outside [0, 1]")
        check(f["acc"].min() >= 0.0 and f["acc"].max() <= 1.0,
              f"frame {k} acc outside [0, 1]")
    fwd_err = max_diff(fwd[0][ok], got[0][ok])
    print(f"[slice] nerf_forward_pass(use_kernel=True) vs K2 on the tile, off "
          f"the kink: comp max|diff| {fwd_err:.3g}", flush=True)

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, blender_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # Both passes end on a sample at z = far: pixels whose coarse or fine
    # last logit is too close to zero to call are held by the frame PSNR.
    with torch.no_grad():
        enc_p = positional_encoding(
            rays.o_march + rays.d_march_unit * (6.0 * rays.d_march_norm), pos_bands)
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        kink, bands = last_bin_kink([
            (fm.fused_nerf_apply(m, enc_p, enc_d)[:, 3],
             m(enc_p, enc_d, compute_dtype=torch.bfloat16)[:, 3])
            for m in (model_c, model_f)])
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k2_frame_s = n_tiles * (coarse_ms + ms) / 1e3
    print(f"[slice] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice] K2 share of a frame: {n_tiles} x (coarse {coarse_ms:.3f} + "
          f"fine {ms:.3f} ms) = {k2_frame_s:.3f} s of {s_frame:.3f} s "
          f"({100 * k2_frame_s / s_frame:.1f}%)", flush=True)
    print(f"[slice] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")

    # ---- 6. kernels line ----
    for key, k in kernels.items():
        k["launches"] = launches[key]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order}
                                  for k in kernels.values()]}))
    check("nerf_sandbox_tpu" not in sys.modules and "jax" not in sys.modules,
          "the JAX package or JAX was imported")
    print(card)
    return name, count


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "nerf_sandbox_tpu_torch")):
        print("chip_smoke: the nerf_sandbox_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        name, count = run(torch, root)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
