"""What holds K3's encode-only entry back? Time it with one part taken out at a time.

    python -m nerf_sandbox_tpu_torch.probe_kplanes_encode

Builds K3's library once per variant of :data:`VARIANTS`, each with its
edits of ``kplanes_encode.cuh`` / ``kplanes_encode.cu``, all at once
(``compare_builds.build_variants``) and times the encode-only kernel of each
on one card in turns (``compare_builds.in_turns``; each the device time of
one call from a CUDA graph of 20, ``chip_smoke.graph_ms``) on the contracted
points of a 360 tile (``compare_builds.points_360``, 3,145,728 rows) with
the full-width tables and with 4-feature planes (``compare_builds.kp_grids``),
printing each time, its share of the bound, the table read rate it implies
and whether its output equals the unedited build's.
The variants that take a part out compute wrong outputs on purpose: the
time a part costs is the unedited time less theirs. The others are
alternative designs of the same outputs (a trig task's bands one at a
time, the staged rows sent by cp.async.bulk copies, the first design's zero
padding written at the start of each tile, streaming stores, 256-thread
blocks, registers capped for 8 blocks an SM in every instantiation, with
and without the values it spills, or at 4 features only, or left to
ptxas, and one instantiation for every group width); each variant's
registers and spills are printed first. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

_EIGHT_BLOCKS = ("__launch_bounds__(KP_THREADS, 7)", "__launch_bounds__(KP_THREADS, 8)")

# name -> {file of csrc/: [(text, its replacement), ...]}, each text found
# there once
VARIANTS = {
    "as built": {},
    # every hat index 0: every lane reads the same texels (L1 broadcasts), the
    # arithmetic stays
    "one texel": {"kplanes_encode.cuh": [(
        "  h.i0 = min(int(floorf(u)), R - 2);",
        "  h.i0 = 0 * min(int(floorf(u)), R - 2);")]},
    # the argument stands in for its sine and cosine
    "no sin/cos": {"kplanes_encode.cuh": [(
        "        sincosf(__fmul_rn(u, k.bands[b]), &sv, &cv);",
        "        sv = __fmul_rn(u, k.bands[b]);\n        cv = -sv;")]},
    # a trig task's bands one after another, not three chains at once
    "bands one at a time": {"kplanes_encode.cuh": [(
        "#pragma unroll\n      for (int i = 0; i < KP_TRIG_BANDS; ++i) {",
        "#pragma unroll 1\n      for (int i = 0; i < KP_TRIG_BANDS; ++i) {")]},
    "no plane tasks": {"kplanes_encode.cuh": [(
        "      kp_plane_any<VF>(k, s, g, x01, out, q);", "")]},
    "no line tasks": {"kplanes_encode.cuh": [(
        "      kp_line_any<VL>(k, kind - k.k_line, x01, out, q);", "")]},
    # rows built in shared memory, nothing written to device memory
    "no device writes": {"kplanes_encode.cu": [(
        "    for (UnitWalk w = row_walk; w.q < n; w.next()) {",
        "    for (UnitWalk w = row_walk; w.q < 0; w.next()) {")]},
    # the staged columns leave by one cp.async.bulk shared->global copy per
    # row (Hopper's bulk copy), the zeros by 16-byte stores beside them
    "cp.async.bulk copies": {"kplanes_encode.cu": [
        ("    __syncthreads();   // x01 in place; the last tile's rows have left",
         "    if (tid < KP_ROWS) asm volatile(\"cp.async.bulk.wait_group.read 0;\" ::: \"memory\");\n"
         "    __syncthreads();"),
        ("    __syncthreads();   // the tile's rows are staged",
         "    asm volatile(\"fence.proxy.async.shared::cta;\" ::: \"memory\");\n"
         "    __syncthreads();\n"
         "    if (tid < n)\n"
         "      asm volatile(\"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n\"\n"
         "                   \"cp.async.bulk.commit_group;\" :: \"l\"(out + size_t(row0 + tid) * EP),\n"
         "                   \"r\"(static_cast<uint32_t>(__cvta_generic_to_shared(\n"
         "                       rows + size_t(tid) * lde))), \"r\"(staged * 16) : \"memory\");"),
        ("      if (w.u < staged) v = *reinterpret_cast<const uint4*>(rows + w.q * lde + 8 * w.u);\n"
         "      *reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + 8 * w.u) = v;",
         "      if (w.u >= staged)\n"
         "        *reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + 8 * w.u) = v;"),
        ("  }\n}\n\nstatic size_t kp_smem",
         "  }\n  if (tid < KP_ROWS) asm volatile(\"cp.async.bulk.wait_group 0;\" ::: \"memory\");\n"
         "}\n\nstatic size_t kp_smem")]},
    # the first design: the zeros go out at the start of the tile, the staged
    # columns at its end, so the line that holds both is written twice
    "zeros ahead of the rows": {"kplanes_encode.cu": [
        ("    __syncthreads();   // x01 in place; the last tile's rows have left",
         "    if (EP > k.c_zero)\n"
         "      for (UnitWalk w(tid, KP_THREADS, (EP - k.c_zero) >> 3); w.q < n; w.next())\n"
         "        *reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + k.c_zero"
         " + 8 * w.u) = make_uint4(0, 0, 0, 0);\n"
         "    __syncthreads();"),
        ("      uint4 v = make_uint4(0, 0, 0, 0);\n",
         "      if (w.u >= staged) continue;\n      uint4 v = make_uint4(0, 0, 0, 0);\n")]},
    # the output stored evict-first (st.global.cs), so that it passes L2 by
    "streaming stores": {"kplanes_encode.cu": [(
        "      *reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + 8 * w.u) = v;",
        "      __stcs(reinterpret_cast<uint4*>(out + size_t(row0 + w.q) * EP + 8 * w.u), v);")]},
    # 256 threads a block: a tile's tasks spread over twice the threads,
    # 3 blocks an SM (at most 85 registers)
    "256 threads a block": {"kplanes_encode.cu": [
        ("constexpr int KP_THREADS = 128;", "constexpr int KP_THREADS = 256;"),
        ("__launch_bounds__(KP_THREADS, 7)", "__launch_bounds__(KP_THREADS, 3)")]},
    # registers capped at 64 in every instantiation, so that 8 blocks (32
    # warps) fit an SM, not 7
    "8 blocks an SM": {"kplanes_encode.cu": [_EIGHT_BLOCKS]},
    # 4-feature planes held to 64 registers, 8 blocks, the others to 72
    "8 blocks an SM at 4 features": {"kplanes_encode.cu": [(
        "__launch_bounds__(KP_THREADS, 7)",
        "__launch_bounds__(KP_THREADS, VF == 4 ? 8 : 7)")]},
    # no bound on the registers: ptxas's own choice
    "registers unbounded": {"kplanes_encode.cu": [(
        "__launch_bounds__(KP_THREADS, 7)", "__launch_bounds__(KP_THREADS)")]},
    # every table set through the instantiation that reads the group widths
    # from its arguments
    "one instantiation for all": {"kplanes_encode.cu": [(
        "  return k.vl != 8 ? 2 : k.vf == 8 ? 0 : k.vf == 4 ? 1 : 2;",
        "  return 2;")]},
    # each trig store of a warp's 32 rows on its own bank (4 rows share one
    # as built): the values land in wrong columns
    "trig stores without conflicts": {"kplanes_encode.cuh": [(
        "        const int col = k.c_hyb + 3 + 3 * b + c;",
        "        const int col = k.c_hyb + 3 + 3 * b + c + 2 * ((q >> 3) & 3);")]},
    # the same, with the registers it spills freed: the points loaded when
    # their tile starts, the copy-out's walk set up per tile
    "8 blocks, registers freed": {"kplanes_encode.cu": [
        _EIGHT_BLOCKS,
        ("  float pv[2];\n  load_points(pts, Q, blockIdx.x, tid, pv);\n", ""),
        ("#pragma unroll\n    for (int e = 0; e < 2; ++e)\n",
         "    float pv[2];\n    load_points(pts, Q, tile, tid, pv);\n"
         "#pragma unroll\n    for (int e = 0; e < 2; ++e)\n"),
        ("    load_points(pts, Q, tile + gridDim.x, tid, pv);   // in flight during the tasks\n",
         ""),
        ("  const UnitWalk row_walk(tid, KP_THREADS, EP >> 3);\n", ""),
        ("    for (UnitWalk w = row_walk; w.q < n; w.next()) {",
         "    for (UnitWalk w(tid, KP_THREADS, EP >> 3); w.q < n; w.next()) {")]},
}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_kplanes_encode: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.compare_builds import (
        build_variants, card_line, in_turns, kp_grids, points_360)
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke

    built = build_variants(cuda_build.CSRC, VARIANTS, "probe_k3", ("kplanes_encode",))
    fns = {}
    for name, (libs, d) in built.items():
        for mangled, e in cs.ptxas_entries((d / "kplanes_encode.log").read_text()).items():
            print(f"[K3 probe] {name}: {cs.kernel_label(mangled)}: {e['regs']} "
                  f"registers, {e['spill_stores']} bytes spill stores", flush=True)
        fns[name] = f = libs["kplanes_encode"].nerf_kplanes_encode
        f.argtypes = ([ctypes.c_void_p, ctypes.c_int] + ke.KP_C_ARGTYPES
                      + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

    dev = torch.device("cuda")
    card = card_line()
    pts = points_360(torch, dev)
    Q = pts.shape[0]
    grids = kp_grids(torch, ke, NeRFMLP, dev)
    for tag, (kcfg, grid) in (("F=8", grids[""]), ("F=4", grids["_f4"])):
        ep = fm._enc_pads(NeRFConfig(kcfg.out_dim, 27))[0]
        args = ke.kp_c_args(grid)
        outs = {name: torch.empty((Q, ep), dtype=torch.bfloat16, device=dev)
                for name in fns}

        def run(name):
            err = fns[name](ctypes.c_void_p(pts.data_ptr()), Q, *args, ep,
                            ctypes.c_void_p(outs[name].data_ptr()),
                            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"{name}: K3 launch: CUDA error {err}")

        times = in_turns(fns, lambda name: cs.graph_ms(torch, lambda: run(name), n=20))
        torch.cuda.synchronize()
        b_ms = cs.bound(0.0, Q * 3 * 4 + Q * ep * 2 + grid.flat.numel() * 2,
                        cs.kplanes_fp32_flops(kcfg) * Q)[0]
        per_row = cs.kplanes_table_bytes(kcfg)
        for name, ts in times.items():
            ms = float(np.mean(ts))
            same = torch.equal(outs[name], outs["as built"])
            print(f"[K3 probe] {tag}, {Q} rows x {ep}, {name}: "
                  f"{', '.join(f'{t:.4f}' for t in ts)} ms, mean {ms:.4f} ms = "
                  f"{100.0 * b_ms / ms:.1f}% of the {b_ms:.4f} ms bound, table reads "
                  f"{per_row * Q / ms / 1e9:.3f} TB/s; output "
                  f"{'equal to' if same else 'differs from'} the unedited build's | "
                  f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
