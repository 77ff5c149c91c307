"""Time two builds of K1, K2 and K3's encode-only entry in turns, on one card.

    python -m nerf_sandbox_tpu_torch.compare_builds --old-csrc DIR [--hidden 128,256,384,512,640,1024] [--rounds N] [--out FILE]

``DIR`` holds an earlier ``csrc/`` (``fused_mlp.cu``, ``fused_raymarch.cu``,
``kplanes_encode.cu`` and the headers they include) whose C entry points are
the current ones: the wgmma tile, with the staged weight stream, and for
hidden widths above 512 the large route's entries with their scratch. Each
build reads the weight stream of its own tree: ``DIR/../ops/fused_mlp.py``'s
``stage_weights``, imported by path, stages the old build's weights. The
script builds ``DIR`` with the package's nvcc flags (one compiler per
source, per part for the sources the package builds in parts, all at once)
into ``build/compare_old/``, builds the current sources as the package
does, and times, in the order old, new, new, old, that order ``--rounds``
times (each a median of 10 CUDA-event runs after warm-up; the medians of
each build's times printed beside them): K1 at 2^20 rows and K2 on the Blender fine
(16384 x 192) eval tile of ``chip_smoke.py`` (frame 1's mid-frame tile) at
each width of ``--hidden`` (8 layers, skip 4; the reference weights at 256,
seeded ones at the others), K2 on the coarse (16384 x 64) tile at each
width from 256, K2's other routes on the fine tile at each width (the
frequency encoder with contraction, IPE with and without, and k-planes with
and without contraction on each table set of :func:`kp_grids`: the
full-width planes of ``chip_smoke.kp_configs``, 4-feature planes and a 4-D
grid, seeded, with an MLP of that width), and K3's encode-only entry on the
contracted points of a 360 tile (16384 rays of frame 1's middle x 192
lindisp samples) for each table set, its device time from CUDA graphs of 20
calls (``chip_smoke.graph_ms``). Both builds are called through ctypes on
the same prepared tensors. It prints each time, old and new outputs' largest
difference, the card's name and power limit, and the rate of a copy between
two 16 MB buffers resident in L2 (a lower bound on the card's L2 bandwidth,
for reading the weight-stream rates that ``chip_smoke.py`` prints);
``--out`` also writes them as JSON. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def build_variant(csrc: Path, tag: str,
                  names=("fused_mlp", "fused_raymarch", "kplanes_encode")) -> dict:
    """nvcc each named source of csrc into build/<tag>/ with the package's
    flags, in parallel, a source of ``cuda_build.PARTS`` one compiler per
    part, then linked; each source's compiler report (``-Xptxas -v``) is
    kept as build/<tag>/<name>.log. → {name: loaded library}."""
    from nerf_sandbox_tpu_torch.ops import cuda_build
    out_dir = ROOT / "build" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    objects = [f for f in cuda_build.NVCC_FLAGS if f != "-shared"] + ["-c"]
    procs = {}
    for name in names:
        lib, src = out_dir / f"lib{name}.so", str(csrc / f"{name}.cu")
        objs = [out_dir / f"{name}.{p}.o" for p in range(cuda_build.PARTS.get(name, 0))]
        cmds = ([[nvcc, *objects, f"-DNERF_PART={p}", "-o", str(o), src]
                 for p, o in enumerate(objs)]
                or [[nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), src]])
        procs[name] = ([subprocess.Popen(c, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                        for c in cmds], objs, lib)
    libs = {}
    for name, (ps, objs, lib) in procs.items():
        logs = [p.communicate()[0] for p in ps]
        (out_dir / f"{name}.log").write_text("".join(logs))
        if any(p.returncode for p in ps):
            raise RuntimeError(f"{csrc / name}.cu failed to build:\n{''.join(logs)}")
        if objs:
            link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode:
                raise RuntimeError(f"{csrc / name}.cu failed to link:\n{link.stderr}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def edited_sources(csrc: Path, edits: dict) -> dict:
    """{file of csrc: its text with ``edits[file]`` made}: each edit a pair
    (text, its replacement), the text found in the file exactly once."""
    texts = {}
    for fname, pairs in edits.items():
        text = (csrc / fname).read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"the text to edit is not in {fname} once: {old!r}")
            text = text.replace(old, new)
        texts[fname] = text
    return texts


def build_variants(csrc: Path, variants: dict, prefix: str, names) -> dict:
    """Variants of csrc, {name: {file: edits}} (:func:`edited_sources`),
    each copied under build/<prefix>_<i>/csrc with its edits, the sources
    ``names`` of every copy built at once (:func:`build_variant`, one
    compiler each). → {name: (its libraries by source, its build/ dir)}."""
    from concurrent.futures import ThreadPoolExecutor
    dirs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = ROOT / "build" / f"{prefix}_{i}" / "csrc"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        for fname, text in edited_sources(csrc, edits).items():
            (d / fname).write_text(text)
        dirs[name] = (d, f"{prefix}_{i}")
    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = pool.map(lambda dt: build_variant(*dt, names), dirs.values())
    return {name: (lib, d.parent) for (name, (d, _)), lib in zip(dirs.items(), libs)}


def in_turns(names, time_one) -> dict:
    """``time_one(name)`` for the names in order, then in reverse, so that a
    drift of the card over the run falls on all alike. → {name: [t, t]}."""
    names = list(names)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(time_one(name))
    return times


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def stage_weights_of(csrc: Path):
    """``stage_weights`` of the tree whose kernels are in csrc (its
    ``ops/fused_mlp.py``, imported by path), so that a build reads the
    weight stream its own kernels expect."""
    spec = importlib.util.spec_from_file_location(
        "compare_old_fused_mlp", csrc.parent / "ops" / "fused_mlp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.stage_weights


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def points_360(torch, dev):
    """K3's points: the 360 configuration's frame 1, its mid-frame tile of
    16384 rays x 192 disparity-linear samples, contracted (3,145,728 x 3
    fp32, ray by ray)."""
    import numpy as np

    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.core.encoding import scene_contract
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import stratified_samples
    K = np.array([[cs.FOCAL, 0, cs.IMG / 2], [0, cs.FOCAL, cs.IMG / 2], [0, 0, 1]],
                 np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(K).to(dev), torch.from_numpy(cs.orbit_360_pose(1)).to(dev),
        image_h=cs.IMG, image_w=cs.IMG, pixel_center=True)
    sl = slice(cs.IMG * cs.IMG // 2, cs.IMG * cs.IMG // 2 + cs.EVAL_CHUNK)
    z = stratified_samples(cs.NEAR_360, cs.FAR_360, 192, lindisp=True, device=dev)
    return scene_contract(
        (rays.o_march[sl][:, None, :] + rays.d_march_unit[sl][:, None, :]
         * (z * rays.d_march_norm[sl])[..., None]).reshape(-1, 3)).contiguous()


def kp_grids(torch, ke, NeRFMLP, dev) -> dict:
    """The k-planes tables K2's k-planes routes and K3 are compared on, by
    route suffix: "" the 360 configuration at full width
    (``chip_smoke.kp_configs``), "_f4" with 4-feature planes, "_4d" with
    time_res 8, its time tables moved off 1.0 by N(0, 0.1) and folded at
    t = 0.37 (chip_smoke.py phase 4b's K3t), each from a seeded model. →
    {suffix: (KPlanesConfig, PackedKPlanes)}."""
    import chip_smoke as cs
    kcfg, _ = cs.kp_configs()
    out = {}
    for suffix, kc, seed in (("", kcfg, 2), ("_f4", kcfg._replace(plane_features=4), 5),
                             ("_4d", kcfg._replace(time_res=8), 3)):
        grid = NeRFMLP(cs.kp_configs()[1]._replace(enc_pos_dim=kc.out_dim),
                       generator=torch.Generator().manual_seed(seed), grid_cfg=kc,
                       device=dev).pos_grid
        if kc.time_res:
            g = torch.Generator().manual_seed(4)
            with torch.no_grad():
                for name, tab in grid.named_parameters():
                    if name == "line_t" or name.split("_")[-1] in ("xt", "yt", "zt"):
                        tab += 0.1 * torch.randn(tab.shape, generator=g).to(dev)
        out[suffix] = (kc, ke.pack_kplanes(grid, kc, t=0.37 if kc.time_res else None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-csrc", required=True, type=Path)
    ap.add_argument("--hidden", default="256",
                    help="comma-separated hidden widths for K1 and K2 (default 256)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times each comparison runs the order old, new, new, old")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    old = build_variant(args.old_csrc, "compare_old")
    cuda_build.build_all(("fused_mlp", "fused_raymarch", "kplanes_encode"))
    print(f"[compare] built old and new in {time.perf_counter() - t0:.1f} s | {card}",
          flush=True)

    cfg = NeRFConfig(63, 27, 8, 256, 4)
    sd = np.load(ROOT / "tests" / "golden" / "mlp_state.npz")
    model_f = NeRFMLP(cfg, device=dev)
    model_f.load_state_dict({k: torch.from_numpy(sd[k]) for k in sd.files})
    model_c = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    ep_pad, ed_pad = fm._enc_pads(cfg)
    widths = [int(h) for h in args.hidden.split(",")]
    packs, staged, scratch = {}, {}, {}
    old_stage = stage_weights_of(args.old_csrc)
    for H in widths:
        m = model_f if H == 256 else NeRFMLP(
            NeRFConfig(63, 27, 8, H, 4), generator=torch.Generator().manual_seed(H),
            device=dev)
        packs[H] = pk = fm.pack_nerf_params(m)
        staged["new", H] = pk.staged
        staged["old", H] = old_stage(pk.cfg, pk.views).contiguous()
        if fm.is_large(pk.cfg):
            scratch[H] = fm.large_scratch(pk.cfg, dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def large_args(H):
        """The large route's scratch arguments, or none below 513."""
        return [_ptr(scratch[H][0]), scratch[H][1]] if H in scratch else []

    # K1 inputs, as chip_smoke's phase 3 at 2^20 rows
    rng = np.random.RandomState(0)
    Q = 1 << 20
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    k1_out = {(k, H): torch.empty((Q, 4), dtype=torch.float32, device=dev)
              for k in ("old", "new") for H in widths}
    libs = {"old": old, "new": {n: cuda_build.load(n) for n in old}}
    routes = sorted({H in scratch for H in widths})   # the entries these widths use
    f = {}
    for w in libs:
        for large in routes:
            fn = getattr(libs[w]["fused_mlp"],
                         "nerf_fused_mlp_large" if large else "nerf_fused_mlp")
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_void_p] + [ctypes.c_int] * 8
                           + ([ctypes.c_void_p, ctypes.c_int] if large else [])
                           + [ctypes.c_void_p] * 2)
            f[w, large] = fn

    def k1(which, H):
        pk = packs[H]
        err = f[which, H in scratch](
            _ptr(ep), _ptr(ed), _ptr(pk.flat), fm.offsets_arg(pk),
            _ptr(staged[which, H]), Q, 63, 27, H, ep_pad, ed_pad, 8, 4,
            *large_args(H), _ptr(k1_out[which, H]), stream)
        if err:
            raise RuntimeError(f"{which} K1 launch: CUDA error {err}")

    # K2 inputs: chip_smoke's Blender fine and coarse tiles
    pos_bands, dir_bands = vanilla_encoders()
    Kmat = np.array([[cs.FOCAL, 0, cs.IMG / 2], [0, cs.FOCAL, cs.IMG / 2], [0, 0, 1]],
                    np.float32)
    rays = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(cs.blender_pose(1)).to(dev),
        image_h=cs.IMG, image_w=cs.IMG, pixel_center=True)
    sl = slice(cs.IMG * cs.IMG // 2, cs.IMG * cs.IMG // 2 + cs.EVAL_CHUNK)
    ro, rd = rays.o_march[sl].contiguous(), rays.d_march_unit[sl].contiguous()
    rn = rays.d_march_norm[sl].reshape(-1).contiguous()
    enc_dir = positional_encoding(rays.d_world_unit[sl], dir_bands).contiguous()
    with torch.no_grad():
        zc = stratified_samples(2.0, 6.0, 64, device=dev).expand(cs.EVAL_CHUNK, 64)
        _, w_c, _, _ = fr.fused_raymarch(model_c, ro, rd, zc, rn, enc_dir, pos_bands)
        zf = merge_z_samples(zc, resample_midpoints(zc, w_c, 128,
                                                    deterministic=True)).contiguous()
    zc = zc.contiguous()
    bands = np.asarray(pos_bands, np.float32).reshape(-1)
    c_bands = (ctypes.c_float * bands.size)(*bands.tolist())
    g = {}
    tail = [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for w in libs:
        for large in routes:
            fn = getattr(libs[w]["fused_raymarch"],
                         "nerf_fused_raymarch_large" if large else "nerf_fused_raymarch")
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                           + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                              ctypes.c_void_p] + tail + ke.KP_C_ARGTYPES
                           + ([ctypes.c_void_p, ctypes.c_int] if large else [])
                           + [ctypes.c_void_p] * 3)
            g[w, large] = fn
    coarse = [H for H in widths if H >= 256]
    # K4's pixel-cone radii (any positive values do for comparing builds),
    # and the k-planes routes' tables (kp_grids) and MLPs of each width
    radii = (rn * 5e-4).contiguous()
    grids = kp_grids(torch, ke, NeRFMLP, dev)
    others = ["freq_contract", "ipe", "ipe_contract"] + [
        f"kplanes{c}{g}" for g in grids for c in ("", "_contract")]
    kp_packs = {}
    for H in widths:
        for P in sorted({kc.out_dim for kc, _ in grids.values()}):
            kp_packs[P, H] = pk = fm.pack_nerf_params(NeRFMLP(
                NeRFConfig(P, 27, 8, H, 4),
                generator=torch.Generator().manual_seed(H + 1), device=dev))
            staged["new", P, H] = pk.staged
            staged["old", P, H] = old_stage(pk.cfg, pk.views).contiguous()
    tiles = {}
    for name, z, H in ([("fine", zf, H) for H in widths]
                       + [("coarse", zc, H) for H in coarse]
                       + [(r, zf, H) for r in others for H in widths]):
        B, N = z.shape
        outs = {k: (torch.empty((B, 5), dtype=torch.float32, device=dev),
                    torch.empty((B, N), dtype=torch.float32, device=dev))
                for k in ("old", "new")}
        tiles[name, H] = (z, outs)

    def k2(which, name, H):
        z, outs = tiles[name, H]
        B, N = z.shape
        kp = name.startswith("kplanes")
        if kp:
            kcfg, grid = grids[name.replace("kplanes", "").replace("_contract", "")]
            P = kcfg.out_dim
            pk, st = kp_packs[P, H], staged[which, P, H]
            ep = fm._enc_pads(pk.cfg)[0]
        else:
            pk, st, ep = packs[H], staged[which, H], ep_pad
        rest = [B, N, 27, H, ep, ed_pad, 8, 4, 0, 1, 0, 0.0,
                int("contract" in name),
                _ptr(radii) if name.startswith("ipe") else None,
                *(ke.kp_c_args(grid) if kp
                  else [None, None, None, 0, 0, 0, 0, 0, 0.0, None, 0]),
                *large_args(H), _ptr(outs[which][0]), _ptr(outs[which][1]), stream]
        rays = [_ptr(ro), _ptr(rd), _ptr(rn), _ptr(enc_dir), _ptr(z)]
        weights = [c_bands, bands.size, 1, _ptr(pk.flat), fm.offsets_arg(pk)]
        err = g[which, H in scratch](*rays, 1, *weights, _ptr(st), *rest)
        if err:
            raise RuntimeError(f"{which} K2 launch: CUDA error {err}")

    # K3 inputs: the tables of K2's k-planes routes on contracted points
    pts = points_360(torch, dev)
    k3_ep = {g: fm._enc_pads(NeRFConfig(kc.out_dim, 27))[0] for g, (kc, _) in grids.items()}
    k3_out = {(k, g): torch.empty((pts.shape[0], k3_ep[g]), dtype=torch.bfloat16,
                                  device=dev)
              for k in ("old", "new") for g in grids}
    h = {w: libs[w]["kplanes_encode"].nerf_kplanes_encode for w in libs}
    for fn in h.values():
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + ke.KP_C_ARGTYPES
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

    def k3(which, g):
        # on the current stream, so that graph_ms can capture it
        err = h[which](_ptr(pts), pts.shape[0], *ke.kp_c_args(grids[g][1]), k3_ep[g],
                       _ptr(k3_out[which, g]),
                       ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{which} K3 launch: CUDA error {err}")

    result = {"card": card}
    runs = [(f"K1 2^20 rows H={H}", lambda w, H=H: k1(w, H)) for H in widths]
    runs += [(f"K2 fine 16384x192 H={H}", lambda w, H=H: k2(w, "fine", H))
             for H in widths]
    runs += [(f"K2 coarse 16384x64 H={H}", lambda w, H=H: k2(w, "coarse", H))
             for H in coarse]
    runs += [(f"K2 {r} fine 16384x192 H={H}", lambda w, r=r, H=H: k2(w, r, H))
             for r in others for H in widths]
    runs += [(f"K3 encode-only {pts.shape[0]} rows{g or '_f8'} (device)",
              lambda w, g=g: k3(w, g)) for g in grids]
    for label, fn in runs:
        # K3 from CUDA graphs of 20 calls: device time, not the host's per call
        timer = ((lambda f: cs.graph_ms(torch, f, n=20)) if label.startswith("K3")
                 else (lambda f: cs.cuda_ms(torch, f)))
        times = []
        for which in ("old", "new", "new", "old") * args.rounds:
            times.append((which, timer(lambda: fn(which))))
        torch.cuda.synchronize()
        old_ms = np.median([t for w, t in times if w == "old"])
        new_ms = np.median([t for w, t in times if w == "new"])
        print(f"[compare] {label}: (old, new, new, old) x {args.rounds} = "
              f"{', '.join(f'{t:.3f}' for _, t in times)} ms; median old {old_ms:.3f} "
              f"ms, new {new_ms:.3f} ms: {old_ms / new_ms:.3f}x | {card}", flush=True)
        result[label] = {"order": [w for w, _ in times], "ms": [t for _, t in times]}
    d_k1 = {H: float((k1_out["old", H] - k1_out["new", H]).abs().max()) for H in widths}
    d_k2 = {f"{n} H={H}": [float((o["old"][i] - o["new"][i]).abs().max()) for i in (0, 1)]
            for (n, H), (_, o) in tiles.items()}
    n_k3 = {g or "_f8": int((k3_out["old", g] != k3_out["new", g]).sum()) for g in grids}
    same = {f"K1 H={H}": torch.equal(k1_out["old", H], k1_out["new", H]) for H in widths}
    same.update({f"K2 {n} H={H}": all(torch.equal(o["old"][i], o["new"][i]) for i in (0, 1))
                 for (n, H), (_, o) in tiles.items()})
    same.update({f"K3 {g}": n == 0 for g, n in n_k3.items()})
    print(f"[compare] old vs new outputs: K1 max|diff| by width {d_k1}; K2 (raw, w) "
          f"max|diff| {d_k2}; K3 values that differ by table set {n_k3}; "
          f"bit-identical: {same}; all bit-identical: {all(same.values())}", flush=True)
    result["max_diff"] = {"K1": d_k1, "K2": d_k2, "K3_values_differ": n_k3}
    result["bit_identical"] = same

    # copies between two 16 MB buffers that stay in the 50 MB L2, timed from
    # a CUDA graph of 20 so that launch gaps do not count
    x = torch.ones(8 << 20, dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)
    ms = cs.graph_ms(torch, lambda: y.copy_(x), n=20)
    rate = 2 * x.numel() * 2 / ms / 1e9
    print(f"[compare] copy of 16 MB resident in L2: {ms:.4f} ms = {rate:.3f} TB/s "
          f"read + written (a lower bound on L2 bandwidth) | {card}", flush=True)
    result["l2_copy_TBps"] = rate
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
