"""Does the weight stream from L2 bound the MLP tile? Time K1 with and without it.

    python -m nerf_sandbox_tpu_torch.probe_weight_stream

Copies ``csrc/`` twice under ``build/``: once as it is, once with the
producer's bulk copy replaced by a bare arrival on the stage's barrier (the
consumers then run on whatever the stages hold: the output is wrong, the
work and the synchronisation are the same, the ~1.2 MB of weights are no
longer read from L2 once per 128 rows). Builds K1 from both and times them
on one card in the order with, without, without, with (each a median of 10
CUDA-event runs) at 2^20 rows of the 8x256 MLP, and prints the weight bytes
each call streams with the rate they imply. If the two times are close, the
L2 stream is not what holds the kernel back (and pairing blocks in a cluster
to halve it would not help). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
COPY = ("    mbar_expect_tx(full, bytes);\n"
        "    bulk_load(S.ring + s * tbytes, src + off, bytes, full);\n")
NO_COPY = ('    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" '
           ':: "r"(full) : "memory");\n')


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_weight_stream: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from nerf_sandbox_tpu_torch.compare_builds import build_variant
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
    from nerf_sandbox_tpu_torch.ops import fused_mlp as fm

    csrc = ROOT / "nerf_sandbox_tpu_torch" / "csrc"
    libs = {}
    for tag in ("with", "without"):
        d = ROOT / "build" / f"probe_stream_{tag}" / "csrc"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        if tag == "without":
            tile = d / "mlp_tile.cuh"
            text = tile.read_text()
            if text.count(COPY) != 1:
                raise RuntimeError("the producer's copy is not where this probe "
                                   "expects it in csrc/mlp_tile.cuh")
            tile.write_text(text.replace(COPY, NO_COPY))
        libs[tag] = build_variant(d, f"probe_stream_{tag}", ("fused_mlp",))["fused_mlp"]

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = NeRFConfig(63, 27, 8, 256, 4)
    packed = fm.pack_nerf_params(
        NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev))
    Q = 1 << 20
    g = torch.Generator(device=dev).manual_seed(0)
    ep = torch.randn(Q, 63, device=dev, generator=g).to(torch.bfloat16)
    ed = torch.randn(Q, 27, device=dev, generator=g).to(torch.bfloat16)
    out = torch.empty(Q, 4, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    offsets = fm.offsets_arg(packed)
    ep_pad, ed_pad = fm._enc_pads(cfg)

    def call(lib):
        f = lib.nerf_fused_mlp
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                               ctypes.c_void_p]
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
        p = [ctypes.c_void_p(t.data_ptr()) for t in (ep, ed, packed.flat)]

        def run():
            err = f(*p, offsets, ctypes.c_void_p(packed.staged.data_ptr()), Q, 63,
                    27, cfg.hidden_dim, ep_pad, ed_pad, cfg.n_layers, cfg.skip_pos,
                    ctypes.c_void_p(out.data_ptr()), stream)
            if err:
                raise RuntimeError(f"K1 launch: CUDA error {err}")
        return run

    runs = {tag: call(lib) for tag, lib in libs.items()}
    nbytes = -(-Q // fm.TILE_M) * packed.staged.numel() * 2
    times = {"with": [], "without": []}
    for tag in ("with", "without", "without", "with"):
        times[tag].append(cs.cuda_ms(torch, runs[tag]))
    for tag, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"[weight stream] K1 at {Q} rows {tag} the weight copies: "
              f"{', '.join(f'{t:.3f}' for t in ts)} ms"
              + (f"; {nbytes / 1e9:.3f} GB from L2 = {nbytes / ms / 1e9:.3f} TB/s"
                 if tag == "with" else "") + f" | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
