#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's eval render paths and its training step on
one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA card

Three render configurations: Blender vanilla (frequency encoder, 8x256 MLP), the
contracted K-Planes-hybrid unbounded-360 one (planes (64, 128) x 8, lines
512 x 16, hybrid L=6, aabb 2.0, mip-NeRF 360 contraction, disparity-linear
samples from 0.125 to 22.5, an 8x256 MLP on the 71 encoder columns), and
mip-NeRF's integrated positional encoding on Blender (the vanilla recipe with
``ipe=True``: each sample a conical-frustum Gaussian over its interval, per-ray
pixel-cone radii). Training runs ``bench.py``'s recipe (phase 8).

Phases (any failure exits non-zero):

1. device line: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel of ``nerf_sandbox_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel) and prints, from each
   library's ``-Xptxas -v`` report (kept beside it, so a cached build reports
   too), every kernel's registers, spills and wgmma-serialization notes
   (C7510-C7520); fails on a spill anywhere, and on such a note in K1 or K2
   at hidden width 128 or 256 or on the large route (above 512);
3. K1 (fused MLP) against its plain PyTorch version at 16384x64 rows with the
   reference's 8x256 weights (``tests/golden/mlp_state.npz``), max |diff|
   <= 0.05, timed with CUDA events (median of 10 after warm-up); beside it,
   as a yardstick the port never calls, the same MLP as a chain of bf16
   cuBLAS calls layer by layer;
4. K2 (fused ray-march) against its plain version on one real eval tile
   (16384 rays x 192 merged samples of frame 1): comp, w, acc 2e-2 and depth
   0.1; early ray termination (eps 1e-4) against none within 1e-3, on the
   reference weights and on a dense variant where ERT fires; timed. For K1
   and every K2 tile timed here and in 4b / 4c a line gives the rows per
   weight fetch, the weight bytes the call pulls from L2 with the rate that
   implies, and the share of the bound;
4b. the 360 configuration with seeded weights, on one real fine tile of its
   frame 1 (16384 x 192): K2 with K2c + K3 against its plain version at
   phase 4's tolerances; K3's encode-only entry on the same (contracted)
   points bit for bit; K2c alone (the frequency model, contracted)
   and K3t (a 4-D grid, time_res 8, time tables N(1, 0.1), folded at
   t = 0.37, finite last bin; Σw·z held at 2e-2 x far) against their plain
   versions; each timed, with its bound;
4c. K4 (the IPE encode inside K2) on phase 4's fine tile with the radii
   ``pixel_cone_radii(FOCAL, |d|)``, against its plain version at phase 4's
   tolerances, ERT (eps 1e-4) against none within 1e-3, and K4 with
   contraction on phase 4b's tile (frequency model); each timed beside the
   frequency tile, with its bound;
5. the slice: ``render_pose`` of two 800x800 Blender-style poses through K2
   (``EvalHyper`` vanilla, ``use_kernel=True``) and one
   ``nerf_forward_pass(use_kernel=True)`` over a fine tile through K1, with
   the launch counters zeroed just before and read just after; frames must
   be finite and in [0, 1], and frame 1 rendered through the plain path
   (``use_kernel=False``) must agree within 2e-2 and at >= 40 dB PSNR; then
   one more frame under ``torch.profiler``: device time by kernel and the
   device's idle share (or "not measured" if the trace holds no CUDA time);
5b. the same for the 360 configuration: two 800x800 orbit poses at radius 1
   through K2's k-planes + contraction instantiation (80 launches a frame),
   and one k-planes ``nerf_forward_pass(use_kernel=True)`` through K3's
   encode-only entry and K1, counters zeroed just before and read just
   after (per route: phase 5 must run only the frequency instantiation,
   5b only the k-planes one); frame 1 against the plain path as in 5; then
   one frame of phase 4b's 4-D model at t = 0.37, every launch folding;
5c. the IPE slice: two 800x800 Blender poses through ``render_pose`` with
   ``EvalHyper(ipe=True, use_kernel=True)`` (80 K2 launches a frame, every
   one on route ``ipe``) and one ``nerf_forward_pass(ipe=True,
   use_kernel=True)`` through K1, counted as in 5; frame 1 against the plain
   path as in 5;
5w. hidden widths 384 and 512 (K1 and K2's wide instantiations): K1 at
   2^20 rows of 8x384 and 8x512 skip-4 MLPs with seeded weights and one 8x512
   Blender fine tile (phase 4's) on the frequency route, against their plain
   versions (phase 3's and phase 4's tolerances), timed with their bounds;
   then one 800x800 frame of the 8x512 model through ``render_pose`` (80
   frequency launches) and each width's ``nerf_forward_pass(use_kernel=True)``
   through K1, counted;
5x. hidden widths above 512 (the large route of K1 and K2, activations in
   global scratch): K1 at 2^20 rows of 8x640 and 8x1024 skip-4 MLPs with
   seeded weights and one 8x1024 Blender fine tile (phase 4's) on the
   frequency route, against their plain versions (phase 3's and phase 4's
   tolerances; depth held as Σw·z at 2e-2 x far, since the seeded model
   leaves rays nearly transparent), timed with their bounds; then, counted,
   the 8x1024 model
   through ``render_rays_chunked`` on that tile's 16384 rays (two K2
   launches, both on the large route) and each width's
   ``nerf_forward_pass(use_kernel=True)`` through K1;
5b4. the 360 configuration with 4-feature planes: K2c + K3 on phase 4b's
   fine tile against its plain version, K3's encode-only entry bit for bit,
   timed; one 800x800 frame through ``render_pose`` and one
   ``nerf_forward_pass`` through K3 + K1, counted;
7. K5, the precision probe: ``a @ b`` on the TPU probe's three shapes in
   the modes bf16, tf32, bf16x3 and fp32, each launch counted, its error
   against the fp64 oracle printed and each output held against its plain
   version within K 2^-23 sum|a||b|; each shape timed in every mode beside
   ``torch.matmul`` on the same shape;
8. training (``train/step.py``) on ``bench.py``'s recipe: its synthetic
   4-frame 800x800 scene, 1024 rays, 8x256, 64 + 128 samples, sigma noise,
   bf16 MLP, Adam 5e-4 with the cosine schedule; 10 warm-up steps and 50
   timed ones: ms/step, train ray-samples/s (rays x (64 + 192) / s, as
   bench.py counts), peak memory; every loss finite, every tensor of the
   state on the card, no kernel launch counted (the JAX train step runs no
   Pallas kernel either); five steps under ``torch.profiler``; one step from the same state and draws on the
   card and on the CPU, loss and PSNR at rtol 1e-2, the gradients within
   5e-2 of their norm together, each array within 0.3 of its norm and at a
   cosine >= 0.95 (JAX's own jitted and op-by-op bf16 steps differ by 1.3%,
   14.8% and 0.989);
6. a ``{"kernels": [...]}`` JSON line with each kernel's launches on its
   path, max |diff| against its plain version, its time, the plain
   version's time, the card's bound for the same work and, where one
   PyTorch call computes the same function, that call's time; then the
   last line ``{"ok": true, "device": {...}}``.

The infinite last bin makes a ray's composite a step function of the sign of
its last sigma logit (``last_bin_kink``). Rays whose logit is closer to zero
than twice the measured kernel-vs-plain logit difference are counted (at
most 5% allowed) and held on every sample but the last (phase 4) or by the
frame PSNR (phase 5); every other ray is held at the tolerances above. With
IPE the last sample's encoding depends on its interval, so the band is
measured on the last sample's frustum Gaussian of each pass.

There is no CPU path: without a CUDA device, or without the package beside
this script, it prints nothing on stdout and exits 2.
"""

import json
import os
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores, H100 SXM
H100_HBM_BYTES = 3.35e12        # HBM3 bandwidth, H100 SXM
N_POSES = 2
IMG = 800
FOCAL = 1111.1
EVAL_CHUNK = 16384
NEAR_360, FAR_360 = 0.125, 22.5   # RESULTS.md "norm": the rig scaled to r = 1


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


def graph_ms(torch, fn, n=100):
    """Device time of one call of ``fn``, from a CUDA graph of ``n`` calls
    replayed as in ``cuda_ms``: for launches shorter than the host's own
    overhead per call, which events around single calls would measure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(torch, graph.replay) / n


def mlp_macs_per_row(cfg):
    """Unpadded multiply-adds of the skip MLP per sample row (vanilla:
    593,408)."""
    from nerf_sandbox_tpu_torch.models.mlp import trunk_in_dims
    H = cfg.hidden_dim
    return (sum(d * H for d in trunk_in_dims(cfg)) + H * H + H
            + (H + cfg.enc_dir_dim) * (H // 2) + (H // 2) * 3)


def bound(flops, nbytes, fp32_flops=0.0):
    """Least time (ms) for the work: the larger of the bytes over HBM's rate
    and the operations over their unit's peak (bf16 tensor cores, fp32)."""
    t_ops = max(flops / H100_BF16_FLOPS, fp32_flops / H100_FP32_FLOPS) * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mlp_passes(B, N):
    """MLP passes of K2 over B rays x N samples (no ERT): each pass is one
    weight fetch for 32 rays x 4 samples."""
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    return -(-B // fr.RAYS_PER_GROUP) * -(-N // fr.SAMPLES_PER_PASS)


def fetch_line(tag, ms, bound_ms, passes, packed, card):
    """Rows per weight fetch, the weight bytes a call pulls from L2 (the
    staged stream once per pass) and the rate that implies, the share of the
    bound."""
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    nbytes = passes * packed.staged.numel() * 2
    print(f"[{tag}] {fm.TILE_M} rows per weight fetch, {passes} fetches of "
          f"{packed.staged.numel() * 2 / 1e6:.3f} MB: {nbytes / 1e9:.3f} GB of "
          f"weights from L2 in {ms:.3f} ms = {nbytes / ms / 1e9:.3f} TB/s; "
          f"{100.0 * bound_ms / ms:.1f}% of the {bound_ms:.3f} ms bound | {card}",
          flush=True)


def mlp_chain_bf16(torch, packed, ep, ed):
    """The same MLP as a chain of bf16 cuBLAS calls (addmm / mv) layer by
    layer, a yardstick for K1 that the port never calls. ep, ed: bf16 rows
    padded to the kernel widths."""
    v, cfg = packed.views, packed.cfg
    H = cfg.hidden_dim
    relu = torch.relu_
    h = relu(torch.addmm(v["b0"], ep, v["w0"]))
    mid = 0
    for layer in range(1, cfg.n_layers):
        if layer == cfg.skip_pos:
            h = relu(torch.addmm(torch.addmm(v["bskip"], h, v["wskip_h"]), ep,
                                 v["wskip_e"]))
        else:
            h = relu(torch.addmm(v["b_mid"][mid], h, v["w_mid"][mid]))
            mid += 1
    sigma = torch.mv(h, v["w_sig"]) + v["b_sig"]
    feat = torch.addmm(v["b_feat"], h, v["w_feat"])
    ch = relu(torch.addmm(torch.addmm(v["bc1"], feat, v["wc1"][:H]), ed,
                          v["wc1"][H:]))
    rgb = torch.addmm(v["bc2"], ch, v["wc2t"].T)
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def profile_frame(torch, render, tag, card):
    """One call of ``render`` (a frame, or training steps) under
    torch.profiler: device time by kernel and the device's idle share of
    its wall time. → (seconds in the fused
    ray-march kernels, profiled wall seconds), or None when the trace holds
    no CUDA time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print(f"[{tag}] torch.profiler: device time by kernel: not measured (the "
              f"trace shows no CUDA time); idle share: not measured", flush=True)
        return None
    by_name = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    busy = sum(us for _, us in by_name.values()) / 1e6
    span = (max(e.time_range.end for e in dev_events)
            - min(e.time_range.start for e in dev_events)) / 1e6
    print(f"[{tag}] torch.profiler: wall {wall:.3f} s (profiled), "
          f"device busy {busy:.3f} s, idle share {100.0 * (1.0 - busy / wall):.1f}% "
          f"of the wall time ({100.0 * (1.0 - busy / span):.1f}% between the first "
          f"and the last kernel) | {card}", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[{tag}]   {us / 1e3:10.3f} ms {100.0 * us / 1e6 / wall:5.1f}% "
              f"x{n:<5d} {name[:90]}", flush=True)
    k2 = sum(us for name, (_, us) in by_name.items() if "fused_raymarch" in name)
    return k2 / 1e6, wall


def kplanes_fp32_flops(kcfg):
    """fp32 operations of K3 per sample: per bilinear lookup 4 corners x F
    multiply-adds plus the second contraction, the products, the 4-D folds,
    the lines, and the hybrid channels (a sin or cos counted as one)."""
    F, Fl, n_s = kcfg.plane_features, kcfg.line_features, len(kcfg.plane_res)
    per_scale = 3 * (4 * 2 * F + 3 * F) + 2 * F
    if kcfg.time_res:
        per_scale += 3 * (2 * 2 * F + F)
    lines = 3 * 2 * 2 * Fl + 2 * Fl
    hybrid = 3 + 6 * kcfg.hybrid_freqs * 2 if kcfg.hybrid_freqs else 0
    return n_s * per_scale + lines + hybrid + 3 * (n_s + 1) * 8


WGMMA_NOTE = re.compile(r"\((C75(?:1\d|20))\)")


def ptxas_entries(log):
    """Each compiled kernel of a ``-Xptxas -v`` report → {mangled name:
    {"regs", "spill_stores", "spill_loads", "notes"}}. A wgmma note of
    C7510-C7520 goes to the function it names, else to the entry being
    compiled; those that say the wgmmas are serialized are the ones that cost
    (C7519, "warpgroup.arrive is injected ...", marks the register hand-off
    of every register-operand wgmma and serializes nothing)."""
    rows, entry, props = {}, None, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            rows.setdefault(entry, dict(regs=None, spill_stores=0, spill_loads=0,
                                        notes=[]))
        elif "Function properties for" in ln:
            props = ln.rsplit(" ", 1)[-1].strip()
        elif "spill" in ln and props == entry and entry:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                rows[entry]["spill_stores"] = int(m.group(1))
                rows[entry]["spill_loads"] = int(m.group(2))
        elif "Used" in ln and "registers" in ln and entry:
            rows[entry]["regs"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        if WGMMA_NOTE.search(ln):
            named = re.search(r"'(_Z\w+)'", ln)
            key = named.group(1) if named else entry
            rows.setdefault(key, dict(regs=None, spill_stores=0, spill_loads=0,
                                      notes=[]))["notes"].append(ln.strip())
    return rows


def hidden_label(h):
    """A K1 / K2 instantiation's hidden width; 0 is the large route."""
    return "H>512, large route" if h == 0 else f"H={h}"


def kernel_label(mangled):
    """A readable name of K1's and K2's instantiations → (label, wide or
    None when not K1/K2); wide is True for the wide path (384 / 512) only,
    False for 128 / 256 and the large route (template width 0)."""
    k5 = re.search(r"precision_dot_kernelILi(\d)E", mangled)
    if k5:
        return f"K5 precision_dot<{('bf16', 'tf32', 'bf16x3', 'fp32')[int(k5.group(1))]}>", None
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled, None
    name = mangled[m.end():m.end() + int(m.group(1))]
    args = [int(a) for a in re.findall(r"L[ib](\d+)E", mangled[m.end() + int(m.group(1)):]
                                        .split("EEv")[0] + "E")]
    if name == "fused_mlp_kernel" and len(args) == 1:
        return f"K1 fused_mlp<{hidden_label(args[0])}>", args[0] > 256
    if name == "fused_raymarch_kernel" and len(args) == 3:
        enc = ("freq", "kplanes", "ipe")[args[0]]
        return (f"K2 fused_raymarch<{enc}{', contract' if args[1] else ''}, "
                f"{hidden_label(args[2])}>", args[2] > 256)
    return name, None


def build_notes(cuda_build):
    """Registers, spills and wgmma notes (C7510-C7520) of every kernel, from
    each library's persisted ``-Xptxas -v`` report (a cached build reports
    too); the notes that serialize wgmmas are printed in full. Fails on a
    spill anywhere and on a serializing note in K1 or K2 at hidden width 128
    or 256 or on the large route. → {label: serializing notes} of the wide
    (384 / 512) ones."""
    wide_notes = {}
    for src in cuda_build.SOURCES:
        log = cuda_build.build_log(src)
        check(log, f"no compiler report for {src}")
        for mangled, e in ptxas_entries(log).items():
            label, wide = kernel_label(mangled)
            codes = {}
            for note in e["notes"]:
                code = WGMMA_NOTE.search(note).group(1)
                codes[code] = codes.get(code, 0) + 1
            serial = [n for n in e["notes"] if "serialized" in n]
            print(f"[build]   {src}: {label}: {e['regs']} registers, "
                  f"{e['spill_stores']} bytes spill stores, {e['spill_loads']} bytes "
                  f"spill loads, wgmma notes {codes or 'none'}, "
                  f"{len(serial)} serializing", flush=True)
            for note in serial:
                print(f"[build]     {note[:300]}", flush=True)
            check(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                  f"{label} spills registers")
            check(wide is not False or not serial,
                  f"{label} (hidden width 128 / 256 or the large route) "
                  f"serializes its wgmmas")
            if wide and serial:
                wide_notes[label] = serial
    return wide_notes


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


NAMES = ("comp", "w", "acc", "depth")


def hold_off_kink(tag, got, want, kink, depth_as_sum=False):
    """Hold K2's outputs against its plain version: rays off the last-bin
    kink on every output (comp, w, acc 2e-2, depth 0.1), every ray on its
    weights before the last sample (2e-2), at most 5% of rays at the kink.
    ``depth_as_sum`` holds depth x acc = Σw·z at 2e-2 x FAR (6) in place of
    depth, as tests/test_torch_cuda.py does: a seeded model leaves rays
    nearly transparent, where depth = Σw·z / acc turns a weight difference
    far inside its tolerance into any depth difference (the plain depth
    difference is printed beside it). → the largest of those differences."""
    import numpy as np
    B, N = got[1].shape
    ok = ~kink
    errs = {n: max_diff(g[ok], w[ok]) for n, g, w in zip(NAMES, got, want)}
    depth_tol = 0.1
    if depth_as_sum:
        print(f"[{tag}] depth max|diff| off the kink {errs['depth']:.3g}, held as "
              f"sum w z instead (acc down to {float(want[2][ok].min()):.3g})",
              flush=True)
        errs["depth"] = max_diff((got[3] * got[2])[ok], (want[3] * want[2])[ok])
        depth_tol = 2e-2 * 6.0
    errs["w[:-1]"] = max_diff(got[1][:, :-1], want[1][:, :-1])
    n_kink = int(kink.sum())
    print(f"[{tag}] tile {B}x{N}: max|diff| vs plain {errs}; {n_kink} rays "
          f"at the last-bin kink, whole-tile comp max|diff| "
          f"{max_diff(got[0], want[0]):.3g}", flush=True)
    check(n_kink <= 0.05 * B, f"{tag}: {n_kink} of {B} rays at the kink")
    for n, tol in zip(NAMES + ("w[:-1]",), (2e-2, 2e-2, 2e-2, depth_tol, 2e-2)):
        check(np.isfinite(errs[n]) and errs[n] <= tol,
              f"{tag} {n} max |diff| {errs[n]} > {tol}")
    return max(errs.values())


def ipe_last_enc(ro, rd, rn, z, radii, pos_bands, contract=False):
    """Each ray's last sample encoded as its frustum Gaussian (K4's plain
    formulas), for ``last_bin_kink``."""
    from nerf_sandbox_tpu_torch.core.encoding import integrated_positional_encoding
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    mean, var = fr.ipe_gaussians(ro, rd, z * rn.reshape(-1, 1), radii.reshape(-1),
                                 contract)
    return integrated_positional_encoding(mean[:, -1], var[:, -1], pos_bands)


def blender_pose(i):
    """Orbit pose i at radius 4 (bench.py:44-51)."""
    import numpy as np
    th = i * np.pi / 6
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]], np.float32)
    c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
    return c2w


def orbit_360_pose(i):
    """The Blender orbit pose scaled to radius 1, the mip-NeRF 360 "norm"
    frame of RESULTS.md (camera rig inside the contraction's unit ball)."""
    c2w = blender_pose(i)
    c2w[:3, 3] /= 4.0
    return c2w


def max_diff(a, b):
    return float((a - b).abs().max())


def ulp_ok(got, want):
    """Within one bf16 ulp: |got - want| <= 2^-7 max(1, |want|)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= 2.0 ** -7 * want.abs().clamp(min=1.0)).all())


def kp_configs():
    """The 360 configuration at full width: (KPlanesConfig, NeRFConfig)."""
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    kcfg = KPlanesConfig((64, 128), 8, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
    return kcfg, NeRFConfig(kcfg.out_dim, 27, 8, 256, 4)


def phase_360_tile(torch, dev, card, packed_freq, kernels):
    """4b: K2c, K3 and K3t on one real fine tile of the 360 configuration,
    against their plain versions, timed. → context for phase 5b."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, scene_contract, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    kcfg, cfg = kp_configs()
    check(cfg.enc_pos_dim == 71, f"k-planes width {cfg.enc_pos_dim} != 71")
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(1),
                      grid_cfg=kcfg, device=dev)
    model_f = NeRFMLP(cfg, generator=torch.Generator().manual_seed(2),
                      grid_cfg=kcfg, device=dev)
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]],
                    np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(orbit_360_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    sl = slice(IMG * IMG // 2, IMG * IMG // 2 + EVAL_CHUNK)   # mid-frame tile
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn, vd = rays.d_march_norm[sl].contiguous(), rays.d_world_unit[sl].contiguous()
    enc_dir = positional_encoding(vd, dir_bands)
    mlp_c, mlp_f = fm.pack_nerf_params(model_c), fm.pack_nerf_params(model_f)
    grid_c = ke.pack_kplanes(model_c.pos_grid, kcfg)
    grid_f = ke.pack_kplanes(model_f.pos_grid, kcfg)
    ep = fm._enc_pads(cfg)[0]
    kw = dict(kp_cfg=kcfg, scene_contraction=True)
    with torch.no_grad():
        zc = stratified_samples(NEAR_360, FAR_360, 64, lindisp=True,
                                device=dev).expand(EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(mlp_c, ro, rd, zc, rn, enc_dir, None,
                                         kp_params=grid_c, **kw)
        z = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                   deterministic=True)).contiguous()
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    names = NAMES
    pts = scene_contract((ro[:, None, :] + rd[:, None, :] * (z * rn)[..., None])
                         .reshape(-1, 3))
    last = pts.reshape(B, N, 3)[:, -1]
    hold = hold_off_kink

    # K2 with K2c + K3, against its plain version
    got = fr.fused_raymarch(mlp_f, ro, rd, z, rn, enc_dir, None,
                            kp_params=grid_f, **kw)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp_f, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid_f))
    torch.cuda.synchronize()
    P = cfg.enc_pos_dim
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(mlp_f, ke.fused_kplanes_encode(grid_f, last, ep)[:, :P],
                            enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(mlp_f, ke.kplanes_encode_plain(grid_f, last, ep)[:, :P],
                                  enc_dir)[:, 3])])
    print(f"[K2c+K3] kink band |logit| < {bands[0]:.3g}", flush=True)
    kp_err = hold("K2c+K3", got, want, kink)

    # K3 on its own, on the same contracted points
    enc_k = ke.fused_kplanes_encode(grid_f, pts, ep)
    enc_p = ke.kplanes_encode_plain(grid_f, pts, ep)
    torch.cuda.synchronize()
    enc_err = max_diff(enc_k.float(), enc_p.float())
    n_off = int((enc_k != enc_p).sum())
    print(f"[K3] encode-only {pts.shape[0]} rows x {ep}: max|diff| {enc_err:.3g}, "
          f"{n_off} of {enc_k.numel()} values differ (bit for bit required)",
          flush=True)
    check(n_off == 0, f"K3 encode-only differs from its plain version in {n_off} values")
    check(not enc_k[:, P:].float().any(), "K3 padding columns are not zero")

    # K2c alone: the frequency model with contraction, on the same tile
    got_c = fr.fused_raymarch(packed_freq, ro, rd, z, rn, enc_dir, pos_bands,
                              scene_contraction=True)
    want_c = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_freq, ro, rd, z, dt, rn, enc_dir, pos_bands, contract=True))
    enc_last = positional_encoding(last, pos_bands)
    kink_c, _ = last_bin_kink([(
        fm.fused_nerf_apply(packed_freq, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(packed_freq, enc_last, enc_dir)[:, 3])])
    c_err = hold("K2c", got_c, want_c, kink_c)

    # K3t: a 4-D grid folded at t = 0.37, its time tables moved off their
    # neutral 1.0 to the spatial tables' N(1, 0.1)
    kcfg4 = kcfg._replace(time_res=8)
    model_t = NeRFMLP(cfg, generator=torch.Generator().manual_seed(3),
                      grid_cfg=kcfg4, device=dev)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for nm, tab in model_t.pos_grid.named_parameters():
            if nm == "line_t" or nm.split("_")[-1] in ("xt", "yt", "zt"):
                tab += 0.1 * torch.randn(tab.shape, generator=g).to(dev)
    mlp_t = fm.pack_nerf_params(model_t)
    grid_t = ke.pack_kplanes(model_t.pos_grid, kcfg4, t=0.37)
    got_t = fr.fused_raymarch(mlp_t, ro, rd, z, rn, enc_dir, None, kp_params=grid_t,
                              kp_cfg=kcfg4, scene_contraction=True,
                              infinite_last_bin=False)
    want_t = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp_t, ro, rd, z, fr._deltas(z, rn, False), rn, enc_dir, None,
        contract=True, kp=grid_t))
    enc_t_ok = ulp_ok(ke.fused_kplanes_encode(grid_t, pts, ep),
                      ke.kplanes_encode_plain(grid_t, pts, ep))
    torch.cuda.synchronize()
    # finite last bin: depth held as sum(w z) at the weight tolerance x z_far
    t_errs = {n: max_diff(g_, w_) for n, g_, w_ in zip(names[:3], got_t, want_t)}
    t_errs["sum_wz"] = max_diff(got_t[3] * got_t[2], want_t[3] * want_t[2])
    print(f"[K3t] 4-D fold (time_res 8, t 0.37), finite last bin: max|diff| "
          f"{t_errs}; encode-only within one bf16 ulp: {enc_t_ok}", flush=True)
    check(enc_t_ok, "K3t encode-only differs by more than one bf16 ulp")
    for n, tol in zip(("comp", "w", "acc", "sum_wz"), (2e-2, 2e-2, 2e-2, 2e-2 * FAR_360)):
        check(np.isfinite(t_errs[n]) and t_errs[n] <= tol,
              f"K3t {n} max |diff| {t_errs[n]} > {tol}")

    # times, bounds and the kernels' entries
    def k2(mlp, zz, **a):
        return lambda: fr.fused_raymarch(mlp, ro, rd, zz, rn, enc_dir, **a)

    kp_ms = cuda_ms(torch, k2(mlp_f, z, pos_bands=None, kp_params=grid_f, **kw))
    kp_coarse_ms = cuda_ms(torch, k2(mlp_f, zc, pos_bands=None, kp_params=grid_f, **kw))
    kp_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp_f, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid_f))
    tfold_ms = cuda_ms(torch, k2(mlp_t, z, pos_bands=None, kp_params=grid_t,
                                 kp_cfg=kcfg4, scene_contraction=True,
                                 infinite_last_bin=False))
    tfold_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp_t, ro, rd, z, fr._deltas(z, rn, False), rn, enc_dir, None,
        contract=True, kp=grid_t))
    freq_ms = cuda_ms(torch, k2(packed_freq, z, pos_bands=pos_bands))
    c_ms = cuda_ms(torch, k2(packed_freq, z, pos_bands=pos_bands,
                             scene_contraction=True))
    c_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_freq, ro, rd, z, dt, rn, enc_dir, pos_bands, contract=True))
    enc_ms = cuda_ms(torch, lambda: ke.fused_kplanes_encode(grid_f, pts, ep))
    enc_plain_ms = cuda_ms(torch, lambda: ke.kplanes_encode_plain(grid_f, pts, ep))
    Q = B * N
    ray_bytes = B * (7 + 27) * 4 + Q * 4 * 3 + B * 5 * 4
    kp_flops = kplanes_fp32_flops(kcfg) * Q
    b_kp = bound(2.0 * mlp_macs_per_row(cfg) * Q,
                 ray_bytes + mlp_f.flat.numel() * 2 + grid_f.flat.numel() * 2,
                 kp_flops + 20.0 * Q)
    b_c = bound(2.0 * mlp_macs_per_row(packed_freq.cfg) * Q,
                ray_bytes + packed_freq.flat.numel() * 2, 20.0 * Q)
    b_enc = bound(0.0, Q * 3 * 4 + Q * ep * 2 + grid_f.flat.numel() * 2, kp_flops)
    b_coarse = bound(2.0 * mlp_macs_per_row(cfg) * B * 64, 0.0)
    print(f"[K2c+K3] fine tile kernel {kp_ms:.3f} ms, plain {kp_plain_ms:.3f} ms, "
          f"bound {b_kp[0]:.3f} ms ({b_kp[1]}); coarse tile {B}x64 kernel "
          f"{kp_coarse_ms:.3f} ms, bound {b_coarse[0]:.3f} ms; K3t (4-D fold) "
          f"fine tile {tfold_ms:.3f} ms, plain {tfold_plain_ms:.3f} ms | {card}",
          flush=True)
    fetch_line("K2c+K3 fine", kp_ms, b_kp[0], mlp_passes(B, N), mlp_f, card)
    fetch_line("K2c+K3 coarse", kp_coarse_ms, b_coarse[0], mlp_passes(B, 64), mlp_f,
               card)
    print(f"[K2c] same tile, frequency model: with contraction {c_ms:.3f} ms, "
          f"without {freq_ms:.3f} ms, plain {c_plain_ms:.3f} ms, bound "
          f"{b_c[0]:.3f} ms ({b_c[1]})", flush=True)
    print(f"[K3] encode-only {Q} rows: kernel {enc_ms:.3f} ms, plain "
          f"{enc_plain_ms:.3f} ms, bound {b_enc[0]:.3f} ms ({b_enc[1]})", flush=True)
    src = "nerf_sandbox_tpu_torch/csrc/"
    kernels["fused_raymarch_contract"] = dict(
        name="fused_raymarch_contract", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:406", max_abs_err=c_err,
        ms=c_ms, plain_ms=c_plain_ms, bound_ms=b_c[0], bound_by=b_c[1],
        library_ms=None)
    kernels["fused_raymarch_kplanes"] = dict(
        name="fused_raymarch_kplanes", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211",
        max_abs_err=max(kp_err, *(t_errs[n] for n in names[:3])), ms=kp_ms,
        plain_ms=kp_plain_ms,
        bound_ms=b_kp[0], bound_by=b_kp[1], library_ms=None)
    kernels["kplanes_encode"] = dict(
        name="kplanes_encode", route="cuda", source=src + "kplanes_encode.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=enc_err,
        ms=enc_ms, plain_ms=enc_plain_ms, bound_ms=b_enc[0], bound_by=b_enc[1],
        library_ms=None)
    return dict(cfg=cfg, kcfg=kcfg, model_c=model_c, model_f=model_f, Kmat=Kmat,
                ro=ro, rd=rd, rn=rn, vd=vd, z=z, enc_dir=enc_dir, got=got,
                kink=kink, kp_ms=kp_ms, kp_coarse_ms=kp_coarse_ms, kcfg4=kcfg4,
                model_t=model_t)


def phase_360_slice(torch, dev, card, ctx):
    """5b: two 800x800 frames of the 360 configuration through K2c + K3, and
    one k-planes ``nerf_forward_pass`` through K3 + K1, counted; frame 1
    against the plain path. → the kernels' launches on this path."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, scene_contract, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    cfg, kcfg, model_c, model_f = (ctx[k] for k in ("cfg", "kcfg", "model_c", "model_f"))
    Kmat = ctx["Kmat"]
    pos_bands, dir_bands = vanilla_encoders()
    hyper = EvalHyper(model=cfg, samp_near=NEAR_360, samp_far=FAR_360, lindisp=True,
                      scene_contraction=True, pos_encoder="kplanes", enc_cfg=kcfg,
                      use_kernel=True)
    tile_k = make_tile_renderer(hyper, None, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), None, dir_bands,
                                device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    ke.fused_kplanes_encode.launches = 0
    fm.fused_nerf_apply.launches = 0
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, orbit_360_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, ctx["ro"], ctx["rd"], ctx["z"],
                                pos_bands=pos_bands, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=ctx["rn"],
                                viewdirs_world_unit=ctx["vd"], infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                pos_encoder="kplanes", enc_cfg=kcfg,
                                scene_contraction=True, device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_kplanes": routes["kplanes"],
                "fused_raymarch_contract": routes["contract"],
                "kplanes_encode": ke.fused_kplanes_encode.launches,
                "fused_mlp": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    expect = 2 * n_tiles * N_POSES
    print(f"[slice 360] launches on this path: {launches}, K2 routes {routes} "
          f"(k-planes + contraction expected {expect}, {2 * n_tiles} a frame)",
          flush=True)
    check(routes["kplanes"] == expect and routes["contract"] == expect,
          f"K2 k-planes/contraction launched {routes}, expected {expect}")
    check(routes["freq"] == routes["tfold"] == routes["ipe"] == 0,
          f"the 360 path ran another K2 instantiation: {routes}")
    check(launches["kplanes_encode"] >= 1 and launches["fused_mlp"] >= 1,
          "K3's encode-only entry or K1 was not launched on the 360 path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"360 frame {k} {key} not finite")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"360 frame {k} rgb outside [0, 1]")
    ok = ~ctx["kink"]
    fwd_err = max_diff(fwd[0][ok], ctx["got"][0][ok])
    print(f"[slice 360] nerf_forward_pass(kplanes, use_kernel=True) vs K2 on the "
          f"tile, off the kink: comp max|diff| {fwd_err:.3g}", flush=True)
    check(fwd_err <= 2e-2, f"K3 + K1 forward vs K2 comp max |diff| {fwd_err}")

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, orbit_360_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the last sample of both passes is at z = far: pixels whose logit there
    # is within the kernel-vs-plain band of 0 are held by the frame PSNR
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(orbit_360_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    P = cfg.enc_pos_dim
    with torch.no_grad():
        pts = scene_contract(rays.o_march + rays.d_march_unit
                             * (FAR_360 * rays.d_march_norm))
        enc_d = positional_encoding(rays.d_world_unit, dir_bands)
        pairs = []
        for m in (model_c, model_f):
            kp = ke.pack_kplanes(m.pos_grid, kcfg)
            pairs.append((
                fm.fused_nerf_apply(m, ke.fused_kplanes_encode(kp, pts, 128)[:, :P],
                                    enc_d)[:, 3],
                m(m.pos_grid(pts, compute_dtype=torch.bfloat16), enc_d,
                  compute_dtype=torch.bfloat16)[:, 3]))
        kink, bands = last_bin_kink(pairs)
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k2_s = n_tiles * (ctx["kp_coarse_ms"] + ctx["kp_ms"]) / 1e3
    print(f"[slice 360] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice 360] K2 share of a frame: {n_tiles} x (coarse "
          f"{ctx['kp_coarse_ms']:.3f} + fine {ctx['kp_ms']:.3f} ms) = {k2_s:.3f} s "
          f"of {s_frame:.3f} s ({100 * k2_s / s_frame:.1f}%)", flush=True)
    print(f"[slice 360] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"360 frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"360 frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"360 frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")

    # one frame of the 4-D model at a fixed time: every K2 launch folds
    tile_t = make_tile_renderer(hyper._replace(enc_cfg=ctx["kcfg4"]), None,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    t0 = time.perf_counter()
    f4 = render_pose(tile_t, ctx["model_t"], ctx["model_t"], orbit_360_pose(1),
                     IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, time=0.37, device=dev)
    torch.cuda.synchronize()
    s4 = time.perf_counter() - t0
    routes4 = dict(fr.fused_raymarch.route_launches)
    print(f"[slice 360, 4-D] one frame at t = 0.37: {s4:.3f} s, K2 routes "
          f"{routes4} (fold expected {2 * n_tiles})", flush=True)
    check(routes4["tfold"] == routes4["kplanes"] == 2 * n_tiles,
          f"4-D frame: K2 routes {routes4}, expected {2 * n_tiles} folds")
    check(np.isfinite(f4["rgb"]).all() and f4["rgb"].min() >= 0.0
          and f4["rgb"].max() <= 1.0, "4-D frame rgb not finite or outside [0, 1]")
    return launches


def ipe_fp32_flops():
    """fp32 operations K4 adds per sample: the interval and moments (~40),
    the lift or the contraction pushforward (~110), and per sin/cos column
    of the L = 10 encode the attenuation's multiplies and exp (60 x 3)."""
    return 150 + 60 * 3


def phase_ipe_tile(torch, dev, card, packed_f, packed_d, t4, ctx360, kernels):
    """4c: K4 on phase 4's Blender fine tile and, with contraction, on phase
    4b's 360 tile, against its plain version; ERT; timed beside the
    frequency tile. → context for phase 5c."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        pixel_cone_radii, vanilla_encoders)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr

    def k1_and_plain(enc, enc_d):
        return (fm.fused_nerf_apply(packed_f, enc, enc_d)[:, 3],
                fm.fused_nerf_apply_plain(packed_f, enc, enc_d)[:, 3])

    pos_bands, _ = vanilla_encoders()
    ro, rd, rn, z, zc, enc_dir = (t4[k] for k in ("ro", "rd", "rn", "z", "zc",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    fx = torch.tensor(FOCAL, dtype=torch.float32, device=dev)
    radii = pixel_cone_radii(fx, rn.reshape(-1))
    print(f"[K4] pixel-cone radii {float(radii.min()):.3g}..{float(radii.max()):.3g}",
          flush=True)

    got = fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir, pos_bands,
                            ipe_radii=radii)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, radii=radii))
    torch.cuda.synchronize()
    kink, bands = last_bin_kink([k1_and_plain(
        ipe_last_enc(ro, rd, rn, z, radii, pos_bands), enc_dir)])
    print(f"[K4] kink band |logit| < {bands[0]:.3g}", flush=True)
    k4_err = hold_off_kink("K4", got, want, kink)

    # ERT on the IPE tile, and on the dense model where whole blocks stop
    for tag, pk in (("golden", packed_f), ("dense", packed_d)):
        full = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                 ipe_radii=radii)
        ert = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands,
                                ipe_radii=radii, ert_eps=1e-4)
        ert_errs = {n: max_diff(g, w) for n, g, w in zip(NAMES, ert, full)}
        print(f"[K4] ERT(1e-4) vs none, {tag} model: max|diff| {ert_errs}; "
              f"{float((ert[1] == 0).float().mean()):.3f} of the weights skipped",
              flush=True)
        for n in NAMES:
            check(np.isfinite(ert_errs[n]) and ert_errs[n] <= 1e-3,
                  f"K4 ERT ({tag}) {n} max |diff| {ert_errs[n]} > 1e-3")

    # K4 with contraction, on the 360 tile (lindisp 0.125..22.5, radius-1 orbit)
    c_ro, c_rd, c_rn, c_z, c_ed = (ctx360[k] for k in ("ro", "rd", "rn", "z",
                                                       "enc_dir"))
    c_radii = pixel_cone_radii(fx, c_rn.reshape(-1))
    got_c = fr.fused_raymarch(packed_f, c_ro, c_rd, c_z, c_rn, c_ed, pos_bands,
                              ipe_radii=c_radii, scene_contraction=True)
    c_dt = fr._deltas(c_z, c_rn, True)
    want_c = fr.fixup_outputs(*fr.fused_raymarch_plain(
        packed_f, c_ro, c_rd, c_z, c_dt, c_rn, c_ed, pos_bands, contract=True,
        radii=c_radii))
    torch.cuda.synchronize()
    kink_c, bands_c = last_bin_kink([k1_and_plain(
        ipe_last_enc(c_ro, c_rd, c_rn, c_z, c_radii, pos_bands, contract=True),
        c_ed)])
    print(f"[K4c] kink band |logit| < {bands_c[0]:.3g}", flush=True)
    k4c_err = hold_off_kink("K4c", got_c, want_c, kink_c)

    # times, the frequency tile between them on the same inputs
    def k2(**a):
        return lambda: fr.fused_raymarch(packed_f, ro, rd, z, rn, enc_dir,
                                         pos_bands, **a)

    freq_ms = cuda_ms(torch, k2())
    ipe_ms = cuda_ms(torch, k2(ipe_radii=radii))
    ipe_coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, ro, rd, zc, rn, enc_dir, pos_bands, ipe_radii=radii))
    ipe_ert_ms = cuda_ms(torch, k2(ipe_radii=radii, ert_eps=1e-4))
    ipe_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, ro, rd, z, dt, rn, enc_dir, pos_bands, radii=radii))
    ipe_c_ms = cuda_ms(torch, lambda: fr.fused_raymarch(
        packed_f, c_ro, c_rd, c_z, c_rn, c_ed, pos_bands, ipe_radii=c_radii,
        scene_contraction=True))
    ipe_c_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        packed_f, c_ro, c_rd, c_z, c_dt, c_rn, c_ed, pos_bands, contract=True,
        radii=c_radii))
    freq_ms2 = cuda_ms(torch, k2())
    Q = B * N
    b_ipe = bound(2.0 * mlp_macs_per_row(packed_f.cfg) * Q,
                  B * (8 + 27) * 4 + Q * 4 * 3 + B * 5 * 4
                  + packed_f.flat.numel() * 2, ipe_fp32_flops() * Q)
    print(f"[K4] fine tile {B}x{N}: IPE kernel {ipe_ms:.3f} ms, frequency "
          f"kernel on the same tile {freq_ms:.3f} / {freq_ms2:.3f} ms (before / "
          f"after), IPE with ERT(1e-4) {ipe_ert_ms:.3f} ms, plain "
          f"{ipe_plain_ms:.3f} ms, bound {b_ipe[0]:.3f} ms ({b_ipe[1]}); coarse "
          f"tile {B}x{zc.shape[1]} IPE kernel {ipe_coarse_ms:.3f} ms | {card}",
          flush=True)
    fetch_line("K4 fine", ipe_ms, b_ipe[0], mlp_passes(B, N), packed_f, card)
    fetch_line("K4 coarse", ipe_coarse_ms, bound(2.0 * mlp_macs_per_row(packed_f.cfg)
                                                 * B * zc.shape[1], 0.0)[0],
               mlp_passes(B, zc.shape[1]), packed_f, card)
    print(f"[K4c] 360 fine tile with contraction: kernel {ipe_c_ms:.3f} ms, "
          f"plain {ipe_c_plain_ms:.3f} ms", flush=True)
    kernels["fused_raymarch_ipe"] = dict(
        name="fused_raymarch_ipe", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:432",
        max_abs_err=max(k4_err, k4c_err), ms=ipe_ms, plain_ms=ipe_plain_ms,
        bound_ms=b_ipe[0], bound_by=b_ipe[1], library_ms=None)
    return dict(radii=radii, got=got, kink=kink, ipe_ms=ipe_ms,
                ipe_coarse_ms=ipe_coarse_ms)


def phase_ipe_slice(torch, dev, card, model_c, model_f, t4, ctx):
    """5c: two 800x800 IPE frames through K4 and one IPE ``nerf_forward_pass``
    through K1, counted; frame 1 against the plain path. → the kernels'
    launches on this path."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import (
        pixel_cone_radii, positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)
    from nerf_sandbox_tpu_torch.render.validation import compute_psnr

    pos_bands, dir_bands = vanilla_encoders()
    Kmat = t4["Kmat"]
    hyper = EvalHyper(model=model_f.cfg, ipe=True, use_kernel=True)
    tile_k = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = 0
    frames, secs = [], []
    for i in range(N_POSES):
        t0 = time.perf_counter()
        frames.append(render_pose(tile_k, model_c, model_f, blender_pose(i),
                                  IMG, IMG, Kmat, eval_chunk=EVAL_CHUNK, device=dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    with torch.no_grad():
        fwd = nerf_forward_pass(model_f, t4["ro"], t4["rd"], t4["z"],
                                pos_bands=pos_bands, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=t4["rn"],
                                viewdirs_world_unit=t4["vd"], infinite_last_bin=True,
                                compute_dtype=torch.bfloat16, use_kernel=True,
                                ipe=True, radii=ctx["radii"], device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_ipe": routes["ipe"],
                "fused_mlp": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    expect = 2 * n_tiles * N_POSES
    print(f"[slice IPE] launches on this path: {launches}, K2 routes {routes} "
          f"(IPE expected {expect}, {2 * n_tiles} a frame)", flush=True)
    check(fr.fused_raymarch.launches == routes["ipe"] == expect,
          f"K2 launched {fr.fused_raymarch.launches} times ({routes}), expected "
          f"{expect} IPE launches")
    check(routes["freq"] == routes["kplanes"] == routes["contract"] == 0,
          f"the IPE path ran another K2 instantiation: {routes}")
    check(launches["fused_mlp"] >= 1, "K1 was not launched on the IPE path")
    for k, f in enumerate(frames):
        for key in ("rgb", "acc", "depth"):
            check(np.isfinite(f[key]).all(), f"IPE frame {k} {key} not finite")
        check(f["rgb"].shape == (IMG, IMG, 3), f"IPE frame {k} rgb shape")
        check(f["rgb"].min() >= 0.0 and f["rgb"].max() <= 1.0,
              f"IPE frame {k} rgb outside [0, 1]")
    ok = ~ctx["kink"]
    fwd_err = max_diff(fwd[0][ok], ctx["got"][0][ok])
    print(f"[slice IPE] nerf_forward_pass(ipe, use_kernel=True) vs K4 on the "
          f"tile, off the kink: comp max|diff| {fwd_err:.3g}", flush=True)
    check(fwd_err <= 2e-2, f"IPE forward vs K4 comp max |diff| {fwd_err}")

    t0 = time.perf_counter()
    plain = render_pose(tile_p, model_c, model_f, blender_pose(1), IMG, IMG,
                        Kmat, eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the kink band on each pass's last sample, whose Gaussian depends on its
    # interval: the coarse z, and the fine z the plain path's coarse pass gives
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(blender_pose(1)).to(dev),
        image_h=IMG, image_w=IMG, pixel_center=True)
    radii = pixel_cone_radii(torch.tensor(Kmat[0, 0], device=dev),
                             rays.d_world_norm[..., 0])
    packed = [fm.pack_nerf_params(m) for m in (model_c, model_f)]
    pairs = [([], []), ([], [])]
    with torch.no_grad():
        for i in range(0, IMG * IMG, EVAL_CHUNK):
            sl = slice(i, i + EVAL_CHUNK)
            ro, rd, rn = rays.o_march[sl], rays.d_march_unit[sl], rays.d_march_norm[sl]
            vd, ra = rays.d_world_unit[sl], radii[sl]
            enc_d = positional_encoding(vd, dir_bands)
            zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(ro.shape[0], 64)
            _, w_c, _, _ = nerf_forward_pass(
                model_c, ro, rd, zc, pos_bands=pos_bands, dir_bands=dir_bands,
                white_bkgd=True, ray_norms=rn, viewdirs_world_unit=vd,
                infinite_last_bin=True, compute_dtype=torch.bfloat16, ipe=True,
                radii=ra, device=dev)
            zf = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                        deterministic=True))
            for j, (m, pk, zz) in enumerate(((model_c, packed[0], zc),
                                             (model_f, packed[1], zf))):
                enc = ipe_last_enc(ro, rd, rn, zz, ra, pos_bands)
                pairs[j][0].append(fm.fused_nerf_apply(pk, enc, enc_d)[:, 3])
                pairs[j][1].append(m(enc, enc_d, compute_dtype=torch.bfloat16)[:, 3])
        kink, bands = last_bin_kink([(torch.cat(k), torch.cat(p)) for k, p in pairs])
    kink = kink.reshape(IMG, IMG).cpu().numpy()
    drgb = np.abs(frames[1]["rgb"] - plain["rgb"]).max(-1)
    d_rgb = float(drgb[~kink].max())
    psnr = compute_psnr(frames[1]["rgb"], plain["rgb"])
    s_frame = sum(secs[1:]) / max(1, len(secs) - 1)
    k4_s = n_tiles * (ctx["ipe_coarse_ms"] + ctx["ipe_ms"]) / 1e3
    print(f"[slice IPE] {N_POSES} frames {IMG}x{IMG}: {secs} s; steady "
          f"{s_frame:.3f} s/frame = {IMG * IMG / s_frame:.0f} rays/s; plain "
          f"path {plain_s:.3f} s/frame | {card}", flush=True)
    print(f"[slice IPE] K4 share of a frame: {n_tiles} x (coarse "
          f"{ctx['ipe_coarse_ms']:.3f} + fine {ctx['ipe_ms']:.3f} ms) = {k4_s:.3f} s "
          f"of {s_frame:.3f} s ({100 * k4_s / s_frame:.1f}%)", flush=True)
    print(f"[slice IPE] frame 1 kernel vs plain path: max|drgb| {d_rgb:.3g} off "
          f"the kink (tol 2e-2); {int(kink.sum())} pixels at the kink "
          f"(|logit| < {bands}), whole-frame max|drgb| {float(drgb.max()):.3g}, "
          f"PSNR {psnr:.2f} dB (min 40)", flush=True)
    check(kink.sum() <= 0.05 * kink.size,
          f"IPE frame 1: {int(kink.sum())} pixels at the last-bin kink")
    check(d_rgb <= 2e-2, f"IPE frame 1 kernel vs plain max |drgb| {d_rgb} > 2e-2")
    check(psnr >= 40.0, f"IPE frame 1 kernel vs plain PSNR {psnr:.2f} dB < 40")
    return launches


def k1_widths(torch, dev, card, widths, kernels, route, reps=10):
    """K1 at 2^20 rows of an 8xH skip-4 MLP with seeded weights for each H
    of ``widths``, against its plain version (phase 3's 0.05), timed with its
    bound; each width's kernels-line row (``fused_mlp_h{H}``). → {H: model}."""
    import numpy as np

    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    rng = np.random.RandomState(widths[0] % 7)
    Q = EVAL_CHUNK * 64
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    models = {}
    for H in widths:
        cfg = NeRFConfig(63, 27, 8, H, 4)
        m = NeRFMLP(cfg, generator=torch.Generator().manual_seed(H), device=dev)
        pk = fm.pack_nerf_params(m)
        got = fm.fused_nerf_apply(pk, ep, ed)
        want = fm.fused_nerf_apply_plain(pk, ep, ed)
        torch.cuda.synchronize()
        err = max_diff(got, want)
        check(torch.isfinite(got).all().item(), f"K1 8x{H} output not finite")
        check(err <= 0.05, f"K1 8x{H} max |diff| {err} > 0.05")
        ms = cuda_ms(torch, lambda: fm.fused_nerf_apply(pk, ep, ed), reps=reps)
        plain_ms = cuda_ms(torch, lambda: fm.fused_nerf_apply_plain(pk, ep, ed), reps=3)
        b_ms, b_by = bound(2.0 * mlp_macs_per_row(cfg) * Q,
                           Q * (63 + 27) * 2 + pk.flat.numel() * 2 + Q * 4 * 4)
        print(f"[K1 8x{H} {route}] Q={Q} max|diff|={err:.3g} (tol 0.05) kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
              f"{2.0 * mlp_macs_per_row(cfg) / 1e6:.3f} MFLOP a row; "
              f"{100.0 * b_ms / ms:.1f}% of the bound) | {card}", flush=True)
        fetch_line(f"K1 8x{H} {route}", ms, b_ms, -(-Q // fm.TILE_M), pk, card)
        kernels[f"fused_mlp_h{H}"] = dict(
            name=f"fused_mlp_h{H}", route="cuda",
            source="nerf_sandbox_tpu_torch/csrc/fused_mlp.cu",
            replaces="nerf_sandbox_tpu/ops/fused_mlp.py:162", max_abs_err=err,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        models[H] = m
    return models


def k2_fine_tile(torch, card, t4, m, kernels, route, reps=10, depth_as_sum=False):
    """K2 through model ``m`` on phase 4's Blender fine tile on the
    frequency route, against its plain version off the last-bin kink (phase
    4's tolerances; ``hold_off_kink``'s ``depth_as_sum``), timed with its
    bound beside the coarse tile; the kernels-line row
    ``fused_raymarch_h{H}``. → (K2's outputs, kink mask)."""
    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr

    pos_bands, _ = vanilla_encoders()
    H = m.cfg.hidden_dim
    tag = f"K2 8x{H} {route}"
    pk = fm.pack_nerf_params(m)
    ro, rd, rn, z, zc, enc_dir = (t4[k] for k in ("ro", "rd", "rn", "z", "zc",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    got = fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir, pos_bands)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        pk, ro, rd, z, dt, rn, enc_dir, pos_bands))
    torch.cuda.synchronize()
    enc_last = positional_encoding(ro + rd * (z[:, -1:] * rn), pos_bands)
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(pk, enc_last, enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(pk, enc_last, enc_dir)[:, 3])])
    print(f"[{tag}] kink band |logit| < {bands[0]:.3g}", flush=True)
    k2_err = hold_off_kink(tag, got, want, kink, depth_as_sum)
    ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, z, rn, enc_dir,
                                                  pos_bands), reps=reps)
    coarse_ms = cuda_ms(torch, lambda: fr.fused_raymarch(pk, ro, rd, zc, rn, enc_dir,
                                                         pos_bands), reps=reps)
    plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        pk, ro, rd, z, dt, rn, enc_dir, pos_bands), reps=3)
    macs = mlp_macs_per_row(m.cfg)
    b_ms, b_by = bound(2.0 * macs * B * N, B * (7 + 27) * 4 + B * N * 4 * 3
                       + B * 5 * 4 + pk.flat.numel() * 2)
    b_coarse = bound(2.0 * macs * B * zc.shape[1], 0.0)[0]
    print(f"[{tag}] fine tile {B}x{N} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({b_by}; {100.0 * b_ms / ms:.1f}% of the bound); "
          f"coarse tile {B}x{zc.shape[1]} kernel {coarse_ms:.3f} ms | {card}",
          flush=True)
    fetch_line(f"{tag} fine", ms, b_ms, mlp_passes(B, N), pk, card)
    fetch_line(f"{tag} coarse", coarse_ms, b_coarse, mlp_passes(B, zc.shape[1]), pk,
               card)
    kernels[f"fused_raymarch_h{H}"] = dict(
        name=f"fused_raymarch_h{H}", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:559", max_abs_err=k2_err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return got, kink


def phase_wide(torch, dev, card, t4, kernels):
    """3w, 4w, 5w: hidden widths 384 and 512, the wide instantiations of K1
    and K2 (activations in shared memory, layers in 32-column chunks). K1 at
    2^20 rows of an 8xH skip-4 MLP with seeded weights, and one 8x512
    Blender fine tile (phase 4's) on the frequency route, against their plain
    versions, timed with their bounds; then one 800x800 Blender frame of the
    8x512 model through ``render_pose`` and each width's
    ``nerf_forward_pass(use_kernel=True)`` through K1, counted. → launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)

    pos_bands, dir_bands = vanilla_encoders()
    models = k1_widths(torch, dev, card, (384, 512), kernels, "wide")
    m = models[512]
    got, kink = k2_fine_tile(torch, card, t4, m, kernels, "wide")
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))

    # 5w: the wide slice, counted
    tile_k = make_tile_renderer(EvalHyper(model=m.cfg, use_kernel=True), pos_bands,
                                dir_bands, device=dev)
    fwd_kw = dict(pos_bands=pos_bands, dir_bands=dir_bands, white_bkgd=True,
                  ray_norms=rn, viewdirs_world_unit=vd, infinite_last_bin=True,
                  compute_dtype=torch.bfloat16, use_kernel=True, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    frame = render_pose(tile_k, m, m, blender_pose(1), IMG, IMG, t4["Kmat"],
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with torch.no_grad():
        fwd = nerf_forward_pass(m, ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_h512": routes["freq"],
                "fused_mlp_h512": fm.fused_nerf_apply.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    check(fr.fused_raymarch.launches == routes["freq"] == 2 * n_tiles,
          f"the 8x512 frame launched K2 {fr.fused_raymarch.launches} times ({routes}), "
          f"expected {2 * n_tiles} frequency launches")
    check(launches["fused_mlp_h512"] >= 1, "K1 8x512 was not launched")
    for key in ("rgb", "acc", "depth"):
        check(np.isfinite(frame[key]).all(), f"8x512 frame {key} not finite")
    check(frame["rgb"].min() >= 0.0 and frame["rgb"].max() <= 1.0,
          "8x512 frame rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K1 8x512 forward vs K2 comp max |diff| {fwd_err}")
    fm.fused_nerf_apply.launches = 0
    with torch.no_grad():
        fwd3 = nerf_forward_pass(models[384], ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    launches["fused_mlp_h384"] = fm.fused_nerf_apply.launches
    check(launches["fused_mlp_h384"] >= 1 and bool(torch.isfinite(fwd3[0]).all()),
          "K1 8x384 was not launched or gave non-finite colours")
    print(f"[slice 8x512] one {IMG}x{IMG} frame {secs:.3f} s, launches {launches}, "
          f"K2 routes {routes}; nerf_forward_pass vs K2 on the tile, off the kink: "
          f"comp max|diff| {fwd_err:.3g} | {card}", flush=True)
    return launches


def phase_large(torch, dev, card, t4, kernels):
    """3x, 4x, 5x: hidden widths above 512, the large route of K1 and K2
    (activations in global scratch, one instantiation for every width). K1 at
    2^20 rows of 8x640 and 8x1024 skip-4 MLPs with seeded weights, and one
    8x1024 Blender fine tile (phase 4's) on the frequency route, against their
    plain versions (phase 3's and 4's tolerances), timed with their bounds;
    then, counted, the 8x1024 model through ``render_rays_chunked`` on phase
    4's 16384 rays (a coarse and a fine K2 launch) and each width's
    ``nerf_forward_pass(use_kernel=True)`` (K1). → launches."""
    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_rays_chunked)

    pos_bands, dir_bands = vanilla_encoders()
    models = k1_widths(torch, dev, card, (640, 1024), kernels, "large", reps=5)
    m = models[1024]
    got, kink = k2_fine_tile(torch, card, t4, m, kernels, "large", reps=5,
                             depth_as_sum=True)
    ro, rd, rn, vd, z = (t4[k] for k in ("ro", "rd", "rn", "vd", "z"))
    B = z.shape[0]

    # 5x: the large route on the renderer's and the forward pass's paths,
    # counted
    tile_k = make_tile_renderer(EvalHyper(model=m.cfg, use_kernel=True), pos_bands,
                                dir_bands, device=dev)
    fwd_kw = dict(pos_bands=pos_bands, dir_bands=dir_bands, white_bkgd=True,
                  ray_norms=rn, viewdirs_world_unit=vd, infinite_last_bin=True,
                  compute_dtype=torch.bfloat16, use_kernel=True, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    fm.fused_nerf_apply.launches = fm.fused_nerf_apply.large_launches = 0
    t0 = time.perf_counter()
    out = render_rays_chunked(tile_k, m, m, ro, rd, rn, vd, eval_chunk=EVAL_CHUNK,
                              device=dev)
    with torch.no_grad():
        fwd = nerf_forward_pass(m, ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_h1024": routes["large"],
                "fused_mlp_h1024": fm.fused_nerf_apply.large_launches}
    check(fr.fused_raymarch.launches == routes["freq"] == routes["large"] == 2,
          f"the 8x1024 tile launched K2 {fr.fused_raymarch.launches} times ({routes}), "
          f"expected 2 frequency launches on the large route")
    check(launches["fused_mlp_h1024"] == fm.fused_nerf_apply.launches == 1,
          "K1 8x1024 was not launched once on the large route")
    for key in ("rgb", "acc", "depth"):
        check(bool(torch.isfinite(out[key]).all()), f"8x1024 render {key} not finite")
    check(float(out["rgb"].min()) >= 0.0 and float(out["rgb"].max()) <= 1.0,
          "8x1024 render rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K1 8x1024 forward vs K2 comp max |diff| {fwd_err}")
    fm.fused_nerf_apply.launches = fm.fused_nerf_apply.large_launches = 0
    with torch.no_grad():
        fwd6 = nerf_forward_pass(models[640], ro, rd, z, **fwd_kw)
    torch.cuda.synchronize()
    launches["fused_mlp_h640"] = fm.fused_nerf_apply.large_launches
    check(launches["fused_mlp_h640"] == 1 and bool(torch.isfinite(fwd6[0]).all()),
          "K1 8x640 was not launched on the large route or gave non-finite colours")
    print(f"[slice 8x1024 large] render_rays_chunked of {B} rays and a forward pass "
          f"{secs:.3f} s, launches {launches}, K2 routes {routes}; nerf_forward_pass "
          f"vs K2 on the tile, off the kink: comp max|diff| {fwd_err:.3g} | {card}",
          flush=True)
    return launches


def bench_scene(torch, dev):
    """``bench.py``'s synthetic scene: 4 frames of 800x800 RGBA noise, focal
    1111.1, cameras on a circle of radius 4 (bench.py:40-52)."""
    import numpy as np

    from nerf_sandbox_tpu_torch.data.sampler import SceneArrays
    from nerf_sandbox_tpu_torch.data.scene import Frame, Scene
    rng = np.random.RandomState(0)
    K = np.array([[FOCAL, 0, IMG / 2], [0, FOCAL, IMG / 2], [0, 0, 1]], np.float32)
    frames = []
    for i in range(4):
        th = i * np.pi / 6
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                [-np.sin(th), 0, np.cos(th)]], np.float32)
        c2w[:3, 3] = c2w[:3, :3] @ np.array([0, 0, 4.0], np.float32)
        frames.append(Frame(image=rng.randint(0, 255, (IMG, IMG, 4), np.uint8), K=K,
                            c2w=c2w))
    return SceneArrays.from_scene(Scene(frames=frames, white_bkgd=True), device=dev)


TRAIN_RAYS, TRAIN_WARMUP, TRAIN_STEPS = 1024, 10, 50


def phase_train(torch, dev, card):
    """8: the training step (``train/step.py``) on ``bench.py``'s recipe: the
    synthetic scene, 1024 rays, 8x256 skip-4, 64 + 128 samples, sigma noise
    1.0, relu, white background, infinite last bin, near 2 / far 6, bf16
    MLP, Adam 5e-4 with cosine T_max 50000 / eta_min 5e-6. Ten warm-up
    steps, then TRAIN_STEPS timed ones: ms/step, train ray-samples/s by
    bench.py's formula (rays x (64 + 192) / s), the peak memory. Every loss
    finite, every tensor of the state on the card, no kernel launched (the
    counters read 0: the JAX train step runs none either); five more steps
    under ``torch.profiler`` (device time by kernel, idle share). Then one step from
    the same state and draws on the card and on the CPU: loss and PSNR at
    rtol 1e-2; all gradients together within 5e-2 of their norm, each
    array within 0.3 of its norm and at a cosine >= 0.95 with the CPU's.
    Those are bounds on two correct bf16 evaluations of one function: the
    JAX step jitted and run op by op differ on the CPU by 1.3% together,
    14.8% in one array, cosine 0.989 (tests/test_torch_train_step.py's
    vanilla case), since bf16 products round where the two accumulate in
    another order and a fine sample moved by the coarse weights' last bits
    moves single entries."""
    import copy

    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import vanilla_encoders
    from nerf_sandbox_tpu_torch.data.sampler import RayBatchSpec, SceneArrays
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.ops import precision_probe as pp
    from nerf_sandbox_tpu_torch.train import step as ts

    scene = bench_scene(torch, dev)
    nc, nf = 64, 128
    hyper = ts.TrainHyper(model=NeRFConfig(63, 27, 8, 256, 4), nc=nc, nf=nf,
                          raw_noise_std=1.0, sigma_activation="relu", white_bkgd=True,
                          infinite_last_bin=True, samp_near=2.0, samp_far=6.0)
    spec = RayBatchSpec(rays_per_batch=TRAIN_RAYS, image_h=IMG, image_w=IMG,
                        white_bkgd=True)
    tx = ts.make_optimizer(5e-4, "cosine", {"T_max": 50_000, "eta_min": 5e-6})
    state = ts.init_train_state(hyper, tx, near=2.0, far=6.0,
                                generator=torch.Generator().manual_seed(0), device=dev)
    pos_b, dir_b = vanilla_encoders()
    step = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, device=dev)

    counters = (fm.fused_nerf_apply, fr.fused_raymarch, ke.fused_kplanes_encode,
                pp.precision_dot)
    for c in counters:
        c.launches = 0
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, scene)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, scene)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launched = {c.__name__: c.launches for c in counters}
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), f"non-finite training losses {losses}")
    check(not any(launched.values()),
          f"the train step launched hand-written kernels: {launched}")
    tensors = ([state.step] + list(ts.named_params(state).values())
               + [t for g in state.opt_state.values() for t in g.values()])
    check(all(t.device.type == "cuda" for t in tensors),
          "a tensor of the train state is not on the card")
    check(int(state.step) == TRAIN_WARMUP + TRAIN_STEPS, f"step {int(state.step)}")
    ms = 1e3 * secs / TRAIN_STEPS
    rate = TRAIN_RAYS * (nc + (nc + nf)) / (secs / TRAIN_STEPS)
    print(f"[train] bench.py recipe ({TRAIN_RAYS} rays, 8x256, 64+128, bf16): "
          f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, {ms:.3f} ms/step, "
          f"{rate:.1f} train ray-samples/s (rays x (64+192) / s), peak memory "
          f"{peak:.3f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f}; kernel "
          f"launches {launched} | {card}", flush=True)

    def five_steps():
        nonlocal state
        for _ in range(5):
            state, _ = step(state, scene)
    profile_frame(torch, five_steps, "train profile, 5 steps", card)

    # one step from the same state and draws, on the card and on the CPU
    g = torch.Generator(device=dev).manual_seed(7)
    draws = ts.make_draws(hyper, spec, scene, state.step + 1, g)
    cpu = torch.device("cpu")
    state_cpu = ts.TrainState(state.step.cpu(), copy.deepcopy(state.model_c).to(cpu),
                              copy.deepcopy(state.model_f).to(cpu),
                              {k: {n: t.cpu() for n, t in v.items()}
                               for k, v in state.opt_state.items()})
    scene_cpu = SceneArrays(*(t.cpu() for t in scene))
    step_cpu = ts.build_train_step(hyper, spec, tx, pos_b, dir_b, device="cpu")
    l_gpu, mse_gpu, g_gpu, _ = step.loss_and_grads(state, scene, draws)
    l_cpu, mse_cpu, g_cpu, _ = step_cpu.loss_and_grads(
        state_cpu, scene_cpu, {k: v.cpu() for k, v in draws.items()})
    psnr = [float(ts.mse2psnr(x)) for x in (mse_gpu, mse_cpu)]
    d_loss = abs(float(l_gpu) / float(l_cpu) - 1.0)
    d_psnr = abs(psnr[0] / psnr[1] - 1.0)
    norm = torch.linalg.vector_norm
    g_gpu = {k: v.cpu() for k, v in g_gpu.items()}
    per = {k: float(norm(g_gpu[k] - g_cpu[k]) / max(float(norm(g_cpu[k])), 1e-30))
           for k in g_cpu}
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g_gpu[k].reshape(1, -1), g_cpu[k].reshape(1, -1))) for k in g_cpu}
    flat = [torch.cat([g[k].reshape(-1) for k in sorted(g_cpu)]) for g in (g_gpu, g_cpu)]
    d_all = float(norm(flat[0] - flat[1]) / norm(flat[1]))
    worst = max(per, key=per.get)
    print(f"[train] one step, card vs CPU from the same state and draws: loss "
          f"{float(l_gpu):.6f} vs {float(l_cpu):.6f} (rel {d_loss:.3g}, tol 1e-2), "
          f"PSNR {psnr[0]:.4f} vs {psnr[1]:.4f} dB (rel {d_psnr:.3g}, tol 1e-2); "
          f"gradients: all together {d_all:.3g} of their norm (tol 5e-2), the "
          f"farthest array {worst} {per[worst]:.3g} of its norm (tol 0.3), lowest "
          f"cosine {min(cos.values()):.5f} (min 0.95) | {card}", flush=True)
    check(d_loss <= 1e-2 and d_psnr <= 1e-2, "card vs CPU loss / PSNR differ")
    check(d_all <= 5e-2 and per[worst] <= 0.3 and min(cos.values()) >= 0.95,
          f"card vs CPU gradients differ: {d_all:.3g} together, {per[worst]:.3g} "
          f"in {worst}, cosine {min(cos.values()):.5f}")


def phase_kp_narrow(torch, dev, card, ctx, kernels):
    """4b4, 5b4: the 360 configuration with 4-feature planes (planes (64, 128)
    x 4, lines 512 x 16, hybrid 6: 63 columns), whose texels the kernels read
    in groups of 4: K2 with K2c + K3 on phase 4b's fine tile against its plain
    version and K3's encode-only entry bit for bit, timed with their bounds;
    then one 800x800 frame through ``render_pose`` and one
    ``nerf_forward_pass`` through K3 + K1, counted. → launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.core.encoding import scene_contract, vanilla_encoders
    from nerf_sandbox_tpu_torch.models.forward import nerf_forward_pass
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    from nerf_sandbox_tpu_torch.render.renderer import (
        EvalHyper, make_tile_renderer, render_pose)

    src = "nerf_sandbox_tpu_torch/csrc/"
    kcfg = KPlanesConfig((64, 128), 4, 512, 16, aabb_scale=2.0, hybrid_freqs=6)
    cfg = NeRFConfig(kcfg.out_dim, 27, 8, 256, 4)
    model = NeRFMLP(cfg, generator=torch.Generator().manual_seed(5), grid_cfg=kcfg,
                    device=dev)
    mlp, grid = fm.pack_nerf_params(model), ke.pack_kplanes(model.pos_grid, kcfg)
    ep, P = fm._enc_pads(cfg)[0], cfg.enc_pos_dim
    ro, rd, rn, vd, z, enc_dir = (ctx[k] for k in ("ro", "rd", "rn", "vd", "z",
                                                   "enc_dir"))
    B, N = z.shape
    dt = fr._deltas(z, rn, True)
    kw = dict(kp_params=grid, kp_cfg=kcfg, scene_contraction=True)
    got = fr.fused_raymarch(mlp, ro, rd, z, rn, enc_dir, None, **kw)
    want = fr.fixup_outputs(*fr.fused_raymarch_plain(
        mlp, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid))
    pts = scene_contract((ro[:, None, :] + rd[:, None, :] * (z * rn)[..., None])
                         .reshape(-1, 3))
    last = pts.reshape(B, N, 3)[:, -1]
    kink, bands = last_bin_kink([(
        fm.fused_nerf_apply(mlp, ke.fused_kplanes_encode(grid, last, ep)[:, :P],
                            enc_dir)[:, 3],
        fm.fused_nerf_apply_plain(mlp, ke.kplanes_encode_plain(grid, last, ep)[:, :P],
                                  enc_dir)[:, 3])])
    print(f"[K2c+K3 F=4] kink band |logit| < {bands[0]:.3g}", flush=True)
    kp_err = hold_off_kink("K2c+K3 F=4", got, want, kink)
    enc_k = ke.fused_kplanes_encode(grid, pts, ep)
    enc_p = ke.kplanes_encode_plain(grid, pts, ep)
    torch.cuda.synchronize()
    n_off = int((enc_k != enc_p).sum())
    enc_err = max_diff(enc_k.float(), enc_p.float())
    print(f"[K3 F=4] encode-only {pts.shape[0]} rows x {ep}: {n_off} of "
          f"{enc_k.numel()} values differ from the plain version", flush=True)
    check(n_off == 0, f"K3 F=4 encode-only differs from its plain version in {n_off} values")
    kp_ms = cuda_ms(torch, lambda: fr.fused_raymarch(mlp, ro, rd, z, rn, enc_dir, None,
                                                     **kw))
    kp_plain_ms = cuda_ms(torch, lambda: fr.fused_raymarch_plain(
        mlp, ro, rd, z, dt, rn, enc_dir, None, contract=True, kp=grid), reps=3)
    enc_ms = cuda_ms(torch, lambda: ke.fused_kplanes_encode(grid, pts, ep))
    enc_plain_ms = cuda_ms(torch, lambda: ke.kplanes_encode_plain(grid, pts, ep), reps=3)
    Q = B * N
    kp_flops = kplanes_fp32_flops(kcfg) * Q
    b_kp = bound(2.0 * mlp_macs_per_row(cfg) * Q, B * (7 + 27) * 4 + Q * 4 * 3
                 + B * 5 * 4 + mlp.flat.numel() * 2 + grid.flat.numel() * 2,
                 kp_flops + 20.0 * Q)
    b_enc = bound(0.0, Q * 3 * 4 + Q * ep * 2 + grid.flat.numel() * 2, kp_flops)
    print(f"[K2c+K3 F=4] fine tile {B}x{N} kernel {kp_ms:.3f} ms, plain "
          f"{kp_plain_ms:.3f} ms, bound {b_kp[0]:.3f} ms ({b_kp[1]}); K3 encode-only "
          f"{Q} rows kernel {enc_ms:.3f} ms, plain {enc_plain_ms:.3f} ms, bound "
          f"{b_enc[0]:.3f} ms ({b_enc[1]}) | {card}", flush=True)
    kernels["fused_raymarch_kplanes_f4"] = dict(
        name="fused_raymarch_kplanes_f4", route="cuda", source=src + "fused_raymarch.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=kp_err,
        ms=kp_ms, plain_ms=kp_plain_ms, bound_ms=b_kp[0], bound_by=b_kp[1],
        library_ms=None)
    kernels["kplanes_encode_f4"] = dict(
        name="kplanes_encode_f4", route="cuda", source=src + "kplanes_encode.cu",
        replaces="nerf_sandbox_tpu/ops/fused_raymarch.py:211", max_abs_err=enc_err,
        ms=enc_ms, plain_ms=enc_plain_ms, bound_ms=b_enc[0], bound_by=b_enc[1],
        library_ms=None)

    # the F = 4 slice, counted
    _, dir_bands = vanilla_encoders()
    hyper = EvalHyper(model=cfg, samp_near=NEAR_360, samp_far=FAR_360, lindisp=True,
                      scene_contraction=True, pos_encoder="kplanes", enc_cfg=kcfg,
                      use_kernel=True)
    tile_k = make_tile_renderer(hyper, None, dir_bands, device=dev)
    torch.cuda.synchronize()
    fr.reset_launches()
    ke.fused_kplanes_encode.launches = 0
    fm.fused_nerf_apply.launches = 0
    t0 = time.perf_counter()
    frame = render_pose(tile_k, model, model, orbit_360_pose(1), IMG, IMG, ctx["Kmat"],
                        eval_chunk=EVAL_CHUNK, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with torch.no_grad():
        fwd = nerf_forward_pass(model, ro, rd, z, pos_bands=None, dir_bands=dir_bands,
                                white_bkgd=True, ray_norms=rn, viewdirs_world_unit=vd,
                                infinite_last_bin=True, compute_dtype=torch.bfloat16,
                                use_kernel=True, pos_encoder="kplanes", enc_cfg=kcfg,
                                scene_contraction=True, device=dev)
    torch.cuda.synchronize()
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_raymarch_kplanes_f4": routes["kplanes"],
                "kplanes_encode_f4": ke.fused_kplanes_encode.launches}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    check(routes["kplanes"] == routes["contract"] == 2 * n_tiles,
          f"the F = 4 frame: K2 routes {routes}, expected {2 * n_tiles} k-planes launches")
    check(launches["kplanes_encode_f4"] >= 1 and fm.fused_nerf_apply.launches >= 1,
          "K3's encode-only entry or K1 was not launched on the F = 4 path")
    for key in ("rgb", "acc", "depth"):
        check(np.isfinite(frame[key]).all(), f"F = 4 frame {key} not finite")
    check(frame["rgb"].min() >= 0.0 and frame["rgb"].max() <= 1.0,
          "F = 4 frame rgb outside [0, 1]")
    fwd_err = max_diff(fwd[0][~kink], got[0][~kink])
    check(fwd_err <= 2e-2, f"K3 + K1 F = 4 forward vs K2 comp max |diff| {fwd_err}")
    print(f"[slice 360 F=4] one {IMG}x{IMG} frame {secs:.3f} s, launches {launches}, "
          f"K2 routes {routes}; nerf_forward_pass vs K2 on the tile, off the kink: "
          f"comp max|diff| {fwd_err:.3g} | {card}", flush=True)
    return launches


def phase_precision_probe(torch, dev, card, kernels):
    """7: K5 on the TPU probe's shapes in every mode, counted, each output
    held against its plain version; timed beside ``torch.matmul``. → its
    launches."""
    import numpy as np

    from nerf_sandbox_tpu_torch.ops import precision_probe as pp

    torch.cuda.synchronize()
    pp.precision_dot.launches = 0
    rows = pp.run_probe(dev)
    torch.cuda.synchronize()
    launches = {"precision_probe": pp.precision_dot.launches}
    check(launches["precision_probe"] == len(rows),
          f"K5 launched {launches['precision_probe']} times for {len(rows)} products")
    worst = 0.0
    for r in rows:
        a, b = r["a"], r["b"]
        plain = pp.precision_dot_plain(a, b, r["mode"])
        diff = (r["out"].double() - plain).abs()
        tol = a.shape[1] * 2.0 ** -23 * (a.double().abs() @ b.double().abs())
        ok = bool((diff <= tol).all())
        worst = max(worst, float(diff.max()))
        print(f"[K5] {r['shape']:24s} {r['mode']:7s} vs f64: max_abs "
              f"{r['max_abs']:.3e} max_rel {r['max_rel']:.3e}; kernel vs plain "
              f"max|diff| {float(diff.max()):.3e} (within K 2^-23 sum|a||b|: {ok})",
              flush=True)
        check(ok and np.isfinite(r["max_abs"]),
              f"K5 {r['shape']} {r['mode']} differs from its plain version")
    # single launches are shorter than their host overhead: time them from
    # CUDA graphs of 100 calls, each shape in every mode beside torch.matmul
    table = {}
    for shape in dict.fromkeys(r["shape"] for r in rows):
        a, b = next((r["a"], r["b"]) for r in rows if r["shape"] == shape)
        t = {m: graph_ms(torch, lambda m=m: pp.precision_dot(a, b, m)) for m in pp.MODES}
        t["matmul"] = graph_ms(torch, lambda: torch.matmul(a, b))
        table[shape] = t
        print(f"[K5] {shape:24s} {a.shape[0]}x{a.shape[1]}x{b.shape[1]} us per launch: "
              + ", ".join(f"{m} {1e3 * v:.2f}" for m, v in t.items())
              + f"; every mode at or under torch.matmul: "
              f"{all(t[m] <= t['matmul'] for m in pp.MODES)} | {card}", flush=True)
    a, b = next((r["a"], r["b"]) for r in rows if r["shape"].startswith("one-hot"))
    times = table[next(s for s in table if s.startswith("one-hot"))]
    plain_ms = graph_ms(torch, lambda: pp.precision_dot_plain(a, b, "fp32"))
    lib_ms = times["matmul"]
    M, K = a.shape
    N = b.shape[1]
    b_k5 = bound(0.0, (M * K + K * N + M * N) * 4, 2.0 * M * K * N)
    print(f"[K5] {M}x{K}x{N}: plain fp32 (fp64 product) {plain_ms:.4f} ms, bound "
          f"{b_k5[0]:.2e} ms ({b_k5[1]}) | {card}", flush=True)
    kernels["precision_probe"] = dict(
        name="precision_probe", route="cuda",
        source="nerf_sandbox_tpu_torch/csrc/precision_probe.cu",
        replaces="scripts/probe_mosaic_precision.py:26", max_abs_err=worst,
        ms=times["fp32"], plain_ms=plain_ms, bound_ms=b_k5[0], bound_by=b_k5[1],
        library_ms=lib_ms)
    return launches


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
        print(f"[build] {src}: {rep['seconds']:.2f} s", flush=True)
    wide_notes = build_notes(cuda_build)
    print(f"[build] wide (384 / 512) instantiations of K1 and K2 with serialized "
          f"wgmmas: {sorted(wide_notes) or 'none'}", flush=True)

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
    fetch_line("K1", ms, b_ms, -(-Q // fm.TILE_M), packed_f, card)
    ep_pad = fm.pad_cols_bf16(ep, 64)
    ed_pad = fm.pad_cols_bf16(ed, 32)
    chain = mlp_chain_bf16(torch, packed_f, ep_pad, ed_pad)
    chain_err = max_diff(chain.float(), want)
    chain_ms = cuda_ms(torch, lambda: mlp_chain_bf16(torch, packed_f, ep_pad, ed_pad))
    print(f"[K1] yardstick, not used by the port: the same MLP as a chain of bf16 "
          f"cuBLAS calls layer by layer (addmm / mv, bf16 between layers) "
          f"{chain_ms:.3f} ms at Q={Q} (max|diff| vs plain {chain_err:.3g}); K1 "
          f"{ms:.3f} ms = {chain_ms / ms:.2f}x faster | {card}", flush=True)

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
    b_coarse_ms = bound(2.0 * macs * B * zc.shape[1], 0.0)[0]
    fetch_line("K2 fine", ms, b_ms, mlp_passes(B, N), packed_f, card)
    fetch_line("K2 coarse", coarse_ms, b_coarse_ms, mlp_passes(B, zc.shape[1]),
               packed_f, card)

    # ---- 4b. the 360 configuration: K2c, K3 and K3t on one fine tile ----
    ctx360 = phase_360_tile(torch, dev, card, packed_f, kernels)

    # ---- 4c. K4, the IPE encode, on the Blender and 360 fine tiles ----
    t4 = dict(ro=ro, rd=rd, rn=rn, vd=vd, z=z, zc=zc, enc_dir=enc_dir, Kmat=Kmat)
    ctx_ipe = phase_ipe_tile(torch, dev, card, packed_f, packed_d, t4, ctx360,
                             kernels)

    # ---- 5. the slice: render_pose through K2, nerf_forward_pass through K1 ----
    hyper = EvalHyper(model=cfg, use_kernel=True)
    tile_k = make_tile_renderer(hyper, pos_bands, dir_bands, device=dev)
    tile_p = make_tile_renderer(hyper._replace(use_kernel=False), pos_bands,
                                dir_bands, device=dev)
    torch.cuda.synchronize()
    fm.fused_nerf_apply.launches = 0
    fr.reset_launches()
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
    routes = dict(fr.fused_raymarch.route_launches)
    launches = {"fused_mlp": fm.fused_nerf_apply.launches,
                "fused_raymarch": routes["freq"]}
    n_tiles = -(-IMG * IMG // EVAL_CHUNK)
    print(f"[slice] launches on the main path: {launches}, K2 routes {routes} "
          f"(K2 expected {2 * n_tiles * N_POSES})", flush=True)
    check(fr.fused_raymarch.launches == routes["freq"] == 2 * n_tiles * N_POSES,
          f"K2 launched {fr.fused_raymarch.launches} times ({routes}), expected "
          f"{2 * n_tiles * N_POSES} frequency launches")
    check(routes["kplanes"] == routes["contract"] == routes["ipe"] == 0,
          f"the Blender path ran another K2 instantiation: {routes}")
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
    # one more frame under the profiler (after the counts were read)
    traced = profile_frame(torch, lambda: render_pose(
        tile_k, model_c, model_f, blender_pose(1), IMG, IMG, Kmat,
        eval_chunk=EVAL_CHUNK, device=dev), "slice profile", card)
    if traced is not None:
        print(f"[slice profile] K2 in the trace: {traced[0]:.3f} s of the profiled "
              f"{traced[1]:.3f} s frame ({100.0 * traced[0] / traced[1]:.1f}%)",
              flush=True)

    # ---- 5b. the 360 slice: render_pose through K2c + K3 ----
    launches_360 = phase_360_slice(torch, dev, card, ctx360)

    # ---- 5c. the IPE slice: render_pose through K4 ----
    launches_ipe = phase_ipe_slice(torch, dev, card, model_c, model_f, t4, ctx_ipe)

    # ---- 3w, 4w, 5w. hidden widths 384 and 512: K1 and K2's wide path ----
    launches_wide = phase_wide(torch, dev, card, t4, kernels)

    # ---- 3x, 4x, 5x. hidden widths above 512: the large route ----
    launches_large = phase_large(torch, dev, card, t4, kernels)

    # ---- 4b4, 5b4. the 360 configuration with 4-feature planes ----
    launches_kp4 = phase_kp_narrow(torch, dev, card, ctx360, kernels)

    # ---- 7. K5, the precision probe ----
    launches_probe = phase_precision_probe(torch, dev, card, kernels)

    # ---- 8. the training step, bench.py's recipe ----
    phase_train(torch, dev, card)

    # ---- 6. kernels line ----
    for key, k in kernels.items():
        k["launches"] = next(d[key] for d in (launches, launches_360, launches_ipe,
                                              launches_wide, launches_large,
                                              launches_kp4, launches_probe)
                             if key in d)
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
