"""Write csrc/wgmma.cuh, the bf16 -> fp32 wgmma wrappers (shared-memory and
register A operand forms, and the shared-memory form that starts an
accumulation without reading it) for N = 64, 128 and 256.

    python nerf_sandbox_tpu_torch/csrc/gen_wgmma.py

PTX names every accumulator register of a wgmma, so each form is written
out in full; this script does the writing.
"""
from pathlib import Path

HEAD = '''// Hopper warpgroup matrix multiply-accumulate (wgmma) wrappers, bf16 x bf16
// -> fp32, m64nNk16 for N = 64, 128, 256: D (64 x N, fp32 in registers) +=
// A (64 x 16) @ B (16 x N). B is always read from shared memory through a
// matrix descriptor (K-major, 128-byte swizzle); A comes either from shared
// memory through a descriptor (ss) or from four 32-bit registers per thread
// holding bf16 pairs in the accumulator's row/column layout (rs). scale_d = 0
// ignores D's old value; ss0 is ss with scale_d = 0 and D an output only.
// PTX names every register of D, so each form is written out in full (by
// gen_wgmma.py beside this file: edit that, not this); d points into an
// accumulator array that the caller indexes only with constants (it stays
// in registers). Needs sm_90a.
#pragma once

#include <stdint.h>

namespace nerf {

template <int N>
struct Wgmma;
'''


def regs(n, start=0):
    return ", ".join(f"%{start + i}" for i in range(n))


def wrap(nd):
    parts = [regs(16, i) for i in range(0, nd, 16)]
    return ', "\n        "'.join(parts)


def gen(N):
    nd = N // 2
    outs = ",\n          ".join(", ".join(f'"+f"(d[{i}])' for i in range(j, j + 8))
                                  for j in range(0, nd, 8))
    fresh = outs.replace('"+f"', '"=f"')
    ss_asm = (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"\n'
              f'        "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "\n'
              f'        "{{{wrap(nd)}}}, "\n'
              f'        "%{nd}, %{nd + 1}, p, 1, 1, 0, 0;\\n}}\\n"')
    ss0_asm = (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"\n'
               f'        "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "\n'
               f'        "{{{wrap(nd)}}}, "\n'
               f'        "%{nd}, %{nd + 1}, p, 1, 1, 0, 0;\\n}}\\n"')
    rs_asm = (f'"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"\n'
              f'        "wgmma.mma_async.sync.aligned.m64n{N}k16.f32.bf16.bf16 "\n'
              f'        "{{{wrap(nd)}}}, "\n'
              f'        "{{{regs(4, nd)}}}, %{nd + 4}, p, 1, 1, 0;\\n}}\\n"')
    return f'''
template <>
struct Wgmma<{N}> {{
  static constexpr int NACC = {nd};
  __device__ __forceinline__ static void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {{
    asm volatile(
        {ss_asm}
        : {outs}
        : "l"(da), "l"(db), "r"(scale_d));
  }}
  // ss with scale_d = 0, d written only: d's old values are no input, so
  // no register carries a value into the first product of an accumulation.
  __device__ __forceinline__ static void ss0(float* d, uint64_t da, uint64_t db) {{
    asm volatile(
        {ss0_asm}
        : {fresh}
        : "l"(da), "l"(db), "r"(0));
  }}
  __device__ __forceinline__ static void rs(float* d, uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t db,
                                            int scale_d) {{
    asm volatile(
        {rs_asm}
        : {outs}
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
  }}
}};
'''


def render() -> str:
    return HEAD + "".join(gen(n) for n in (64, 128, 256)) + "\n}  // namespace nerf\n"


def main():
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(render())


if __name__ == "__main__":
    main()
