"""Time two builds of K1, K2 and K3's encode-only entry in turns, on one card.

    python -m nerf_sandbox_tpu_torch.compare_builds --old-csrc DIR [--hidden 128,256,384,512] [--out FILE]

``DIR`` holds an earlier ``csrc/`` (``fused_mlp.cu``, ``fused_raymarch.cu``,
``kplanes_encode.cu`` and the headers they include) whose C entry points are
the current ones: the wgmma tile, with the staged weight stream. The script
builds it with the package's nvcc flags, one compiler each, into
``build/compare_old/``, builds the current sources as the package does, and
times, in the order old, new, new, old (each a median of 10 CUDA-event runs
after warm-up): K1 at 2^20 rows and K2 on the Blender fine (16384 x 192)
eval tile of ``chip_smoke.py`` (frame 1's mid-frame tile) at each width of
``--hidden`` (8 layers, skip 4; the reference weights at 256, seeded ones at
the others), K2 on the coarse (16384 x 64) tile at 256, and K3's
encode-only entry on the contracted
points of a 360 tile (16384 rays of frame 1's middle x 192 lindisp samples,
the full-width planes of ``chip_smoke.kp_configs``). Both builds are called
through ctypes on the same prepared tensors. It prints each time, old and new outputs' largest
difference, the card's name and power limit, and the rate of a copy between
two 16 MB buffers resident in L2 (a lower bound on the card's L2 bandwidth,
for reading the weight-stream rates that ``chip_smoke.py`` prints);
``--out`` also writes them as JSON. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
    flags, in parallel. → {name: loaded library}."""
    from nerf_sandbox_tpu_torch.ops import cuda_build
    out_dir = ROOT / "build" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out_dir / f"lib{name}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{csrc / name}.cu failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-csrc", required=True, type=Path)
    ap.add_argument("--hidden", default="256",
                    help="comma-separated hidden widths for K1 and K2 (default 256)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.core.encoding import (
        positional_encoding, scene_contract, vanilla_encoders)
    from nerf_sandbox_tpu_torch.core.rays import get_camera_rays_grid
    from nerf_sandbox_tpu_torch.core.sampling import (
        merge_z_samples, resample_midpoints, stratified_samples)
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import fused_raymarch as fr
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
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
    packs = {}
    for H in widths:
        m = model_f if H == 256 else NeRFMLP(
            NeRFConfig(63, 27, 8, H, 4), generator=torch.Generator().manual_seed(H),
            device=dev)
        packs[H] = fm.pack_nerf_params(m)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

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
    f = {w: libs[w]["fused_mlp"].nerf_fused_mlp for w in libs}
    for fn in f.values():
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 2)
    def k1(which, H):
        pk = packs[H]
        err = f[which](_ptr(ep), _ptr(ed), _ptr(pk.flat), fm.offsets_arg(pk),
                       _ptr(pk.staged), Q, 63, 27, H, ep_pad, ed_pad, 8, 4,
                       _ptr(k1_out[which, H]), stream)
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
    g = {w: libs[w]["fused_raymarch"].nerf_fused_raymarch for w in libs}
    tail = [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for fn in g.values():
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                       + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_void_p] + tail + ke.KP_C_ARGTYPES
                       + [ctypes.c_void_p] * 3)
    tiles = {}
    for name, z, H in [("fine", zf, H) for H in widths] + [("coarse", zc, 256)]:
        B, N = z.shape
        outs = {k: (torch.empty((B, 5), dtype=torch.float32, device=dev),
                    torch.empty((B, N), dtype=torch.float32, device=dev))
                for k in ("old", "new")}
        tiles[name, H] = (z, outs)

    def k2(which, name, H):
        z, outs = tiles[name, H]
        B, N = z.shape
        pk = packs[H]
        rest = [B, N, 27, H, ep_pad, ed_pad, 8, 4,
                0, 1, 0, 0.0, 0, None, None, None, None, 0, 0, 0, 0, 0, 0.0, None, 0,
                _ptr(outs[which][0]), _ptr(outs[which][1]), stream]
        rays = [_ptr(ro), _ptr(rd), _ptr(rn), _ptr(enc_dir), _ptr(z)]
        weights = [c_bands, bands.size, 1, _ptr(pk.flat), fm.offsets_arg(pk)]
        err = g[which](*rays, 1, *weights, _ptr(pk.staged), *rest)
        if err:
            raise RuntimeError(f"{which} K2 launch: CUDA error {err}")

    # K3 inputs: the 360 configuration's tables (seeded) on contracted points
    kcfg, kp_mlp = cs.kp_configs()
    grid = ke.pack_kplanes(NeRFMLP(kp_mlp, generator=torch.Generator().manual_seed(2),
                                   grid_cfg=kcfg, device=dev).pos_grid, kcfg)
    kp_ep = fm._enc_pads(kp_mlp)[0]
    rays_360 = get_camera_rays_grid(
        torch.from_numpy(Kmat).to(dev), torch.from_numpy(cs.orbit_360_pose(1)).to(dev),
        image_h=cs.IMG, image_w=cs.IMG, pixel_center=True)
    z360 = stratified_samples(cs.NEAR_360, cs.FAR_360, 192, lindisp=True, device=dev)
    pts = scene_contract(
        (rays_360.o_march[sl][:, None, :] + rays_360.d_march_unit[sl][:, None, :]
         * (z360 * rays_360.d_march_norm[sl])[..., None]).reshape(-1, 3)).contiguous()
    k3_out = {k: torch.empty((pts.shape[0], kp_ep), dtype=torch.bfloat16, device=dev)
              for k in ("old", "new")}
    h = {w: libs[w]["kplanes_encode"].nerf_kplanes_encode for w in libs}
    for fn in h.values():
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + ke.KP_C_ARGTYPES
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    kp_args = ke.kp_c_args(grid)

    def k3(which):
        err = h[which](_ptr(pts), pts.shape[0], *kp_args, kp_ep, _ptr(k3_out[which]),
                       stream)
        if err:
            raise RuntimeError(f"{which} K3 launch: CUDA error {err}")

    result = {"card": card}
    runs = [(f"K1 2^20 rows H={H}", lambda w, H=H: k1(w, H)) for H in widths]
    runs += [(f"K2 fine 16384x192 H={H}", lambda w, H=H: k2(w, "fine", H))
             for H in widths]
    if 256 in widths:
        runs.append(("K2 coarse 16384x64 H=256", lambda w: k2(w, "coarse", 256)))
    runs.append((f"K3 encode-only {pts.shape[0]} rows", k3))
    for label, fn in runs:
        times = []
        for which in ("old", "new", "new", "old"):
            times.append((which, cs.cuda_ms(torch, lambda: fn(which))))
        torch.cuda.synchronize()
        old_ms = [t for w, t in times if w == "old"]
        new_ms = [t for w, t in times if w == "new"]
        print(f"[compare] {label}: old, new, new, old = "
              f"{', '.join(f'{t:.3f}' for _, t in times)} ms; old {np.mean(old_ms):.3f} "
              f"ms, new {np.mean(new_ms):.3f} ms: {np.mean(old_ms) / np.mean(new_ms):.2f}x"
              f" | {card}", flush=True)
        result[label] = {"order": [w for w, _ in times], "ms": [t for _, t in times]}
    d_k1 = {H: float((k1_out["old", H] - k1_out["new", H]).abs().max()) for H in widths}
    d_k2 = {f"{n} H={H}": [float((o["old"][i] - o["new"][i]).abs().max()) for i in (0, 1)]
            for (n, H), (_, o) in tiles.items()}
    n_k3 = int((k3_out["old"] != k3_out["new"]).sum())
    print(f"[compare] old vs new outputs: K1 max|diff| by width {d_k1}; K2 (raw, w) "
          f"max|diff| {d_k2}; K3 {n_k3} of {k3_out['new'].numel()} values differ",
          flush=True)
    result["max_diff"] = {"K1": d_k1, "K2": d_k2, "K3_values_differ": n_k3}

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
