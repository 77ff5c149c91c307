"""What holds the large route (or the wide path) of K1 back? Time it with one part taken out at a time.

    python -m nerf_sandbox_tpu_torch.probe_large_route [--route wide]

Builds K1 once per variant of :data:`VARIANTS` (with ``--route wide``:
:data:`WIDE_VARIANTS`), each with its edits of ``mlp_tile.cuh``, all at once
(``compare_builds.build_variants``) and times them on one card in turns
(``compare_builds.in_turns``; each a median of 5 CUDA-event runs) at
2^20 rows of 8x640 and 8x1024 (wide: 8x384 and 8x512) skip-4 MLPs with
seeded weights, printing each time, its share of the bound, and whether its
output equals the unedited build's. The variants that take a part out
compute wrong outputs on purpose: the time a part costs is the unedited
time less theirs. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

_WORD_STORES = """\
  bf16* row = g + (n / KC) * (WG_ROWS * KC) + r * KC + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    uint32_t u0, u1;
    large_pack(acc, bias + n, j, relu, u0, u1);
    bf16* p = row + (j / 8) * (WG_ROWS * KC) + (((j % 8) ^ (r & 7)) << 3);
    *reinterpret_cast<uint32_t*>(p) = u0;
    *reinterpret_cast<uint32_t*>(p + 8 * KC) = u1;
  }
}"""

_UNIT_STORES = """\
  bf16* row = g + (n / KC) * (WG_ROWS * KC) + r * KC;
#pragma unroll
  for (int m = 0; m < N / 32; ++m) {
    uint32_t a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) large_pack(acc, bias + n, 4 * m + i, relu, a[i], b[i]);
    quad_transpose(a);
    quad_transpose(b);
    const int j = 4 * m + (lane & 3);   // this lane's n8 group (16-byte unit)
    bf16* p = row + (j / 8) * (WG_ROWS * KC) + (((j % 8) ^ (r & 7)) << 3);
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<uint4*>(p + 8 * KC) = make_uint4(b[0], b[1], b[2], b[3]);
  }
}"""

# name -> edits of csrc/mlp_tile.cuh: (text, its replacement), each text
# found there once
VARIANTS = {
    "as is": [],
    # the epilogue keeps its bias, relu and casts, and stores nothing
    "no epilogue stores": [(
        "    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);\n"
        "    *reinterpret_cast<uint4*>(p + 8 * KC) = make_uint4(b[0], b[1], b[2], b[3]);\n",
        "    if ((a[0] & b[3]) == 0x7fc17fc1u) *reinterpret_cast<uint32_t*>(p) = a[1];\n")],
    # the A ring's slots are taken without waiting and never refilled
    "no A copies": [
        ('        "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %3;\\n"\n'
         '        "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
         '        "[%1], [%2], %3, [%0];\\n}\\n"',
         '        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\\n}\\n"'),
        ("    mbar_wait(bars + 8 * s, (taken / NA) & 1);\n", "")],
    # no fence.proxy.async.global and warpgroup barrier at a layer's end
    "no layer barrier": [(
        "    fence_async_global();\n"
        "    wg_sync(wg);   // the layer's output is in place before the next reads it\n",
        "")],
    # a 4-slot A ring, which leaves room for 3 weight stages in K1, not 4
    "4 A slots": [("constexpr int NA = 3;", "constexpr int NA = 4;")],
    # each bf16 pair stored as one 4-byte word, no transpose within the quad
    "word stores": [(_UNIT_STORES, _WORD_STORES)],
}


_PAIR_STORES = """\
  // odd rows store their pair partner's units first, so that rows r and
  // r + 1 of a store's quarter warp fill all 32 banks, not the same 16
  const int odd = (threadIdx.x >> 2) & 1;
  wg_sync(wg);
#pragma unroll
  for (int m = 0; m < LNC / 32; m += 2) {
    uint32_t x[8], y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = odd ? park[m + 1][i] : park[m][i];
      y[i] = odd ? park[m][i] : park[m + 1][i];
    }
    st_unit(act, 4 * (m + odd) + q, x);
    st_unit(act, 4 * (m + 1 - odd) + q, y);
  }
#pragma unroll
  for (int m = 0; m < N / 32; m += 2) {
    uint32_t u[8], v[8], x[8], y[8];
    wide_units(acc, bias + LNC, m, relu, u);
    wide_units(acc, bias + LNC, m + 1, relu, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = odd ? v[i] : u[i];
      y[i] = odd ? u[i] : v[i];
    }
    st_unit(act, LNC / 8 + 4 * (m + odd) + q, x);
    st_unit(act, LNC / 8 + 4 * (m + 1 - odd) + q, y);
  }
"""

_PLAIN_STORES = """\
  wg_sync(wg);
#pragma unroll
  for (int m = 0; m < LNC / 32; ++m) st_unit(act, 4 * m + q, park[m]);
#pragma unroll
  for (int m = 0; m < N / 32; ++m) {
    uint32_t u[8];
    wide_units(acc, bias + LNC, m, relu, u);
    st_unit(act, LNC / 8 + 4 * m + q, u);
  }
"""

# the wide path's variants (--route wide), as VARIANTS
WIDE_VARIANTS = {
    "as is": [],
    # the layer-end stores keep their packing and transposes, and store nothing
    "no layer-end stores": [(
        "  st_shared_v4(p, u);\n  st_shared_v4(p + 8 * KC * 2, u + 4);\n",
        "  if ((u[0] & u[7]) == 0x7fc17fc1u) st_shared_v4(p, u);\n")],
    # no sigma row dots read back from act at the feature layer
    "no sigma read-back": [(
        "      wide_sigma<H>(S.act[wg], P.p[W_SIG], sg0, sg1);\n", "")],
    # the same stores in column order: rows r and r + 1 of a quarter warp
    # hit the same 16 banks
    "plain stores": [(_PAIR_STORES, _PLAIN_STORES)],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", choices=("large", "wide"), default="large")
    wide = ap.parse_args(argv).route == "wide"
    variants = WIDE_VARIANTS if wide else VARIANTS
    if not torch.cuda.is_available():
        print("probe_large_route: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.compare_builds import build_variants, card_line, in_turns
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import cuda_build
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    route = "wide" if wide else "large"
    built = build_variants(cuda_build.CSRC,
                           {name: {"mlp_tile.cuh": edits} for name, edits in variants.items()},
                           f"probe_{route}", ("fused_mlp",))
    fns = {}
    for name, (libs, _) in built.items():
        f = getattr(libs["fused_mlp"], "nerf_fused_mlp" if wide else "nerf_fused_mlp_large")
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                               ctypes.c_void_p]
                      + [ctypes.c_int] * 8
                      + ([] if wide else [ctypes.c_void_p, ctypes.c_int])
                      + [ctypes.c_void_p] * 2)
        fns[name] = f

    dev = torch.device("cuda")
    card = card_line()
    Q = 1 << 20
    rng = np.random.RandomState(0)
    ep = torch.from_numpy((rng.normal(size=(Q, 63)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    ed = torch.from_numpy((rng.normal(size=(Q, 27)) * 0.5).astype(np.float32)).to(
        dev, torch.bfloat16)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    for H in (384, 512) if wide else (640, 1024):
        cfg = NeRFConfig(63, 27, 8, H, 4)
        pk = fm.pack_nerf_params(
            NeRFMLP(cfg, generator=torch.Generator().manual_seed(H), device=dev))
        scratch = [] if wide else fm.large_scratch(cfg, dev)
        ep_pad, ed_pad = fm._enc_pads(cfg)
        outs = {name: torch.empty((Q, 4), dtype=torch.float32, device=dev) for name in fns}

        def run(name):
            err = fns[name](ptr(ep), ptr(ed), ptr(pk.flat), fm.offsets_arg(pk),
                            ptr(pk.staged), Q, 63, 27, H, ep_pad, ed_pad, 8, 4,
                            *([] if wide else [ptr(scratch[0]), scratch[1]]),
                            ptr(outs[name]), stream)
            if err:
                raise RuntimeError(f"{name}: K1 launch: CUDA error {err}")

        times = in_turns(fns, lambda name: cs.cuda_ms(torch, lambda: run(name), reps=5))
        torch.cuda.synchronize()
        b_ms = cs.bound(2.0 * cs.mlp_macs_per_row(cfg) * Q, 0.0)[0]
        for name, ts in times.items():
            ms = float(np.mean(ts))
            same = torch.equal(outs[name], outs["as is"])
            print(f"[{route} route probe] K1 8x{H} at {Q} rows, {name}: "
                  f"{', '.join(f'{t:.3f}' for t in ts)} ms, mean {ms:.3f} ms = "
                  f"{100.0 * b_ms / ms:.1f}% of the {b_ms:.3f} ms bound; output "
                  f"{'equal to' if same else 'differs from'} the unedited build's | {card}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
