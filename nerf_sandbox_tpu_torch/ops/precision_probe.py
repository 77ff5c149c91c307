"""K5: the matrix-product precision probe (``csrc/precision_probe.cu``).

Replaces the TPU probe ``scripts/probe_mosaic_precision.py`` (Pallas body
``_dot_kernel``, run at default / HIGH / HIGHEST precision): one fp32
``a @ b`` inside a hand-written kernel, whose error against an fp64 oracle
tells what a precision mode costs. On the card the modes are the ones the
port's kernels could use: ``bf16`` (one pass on bf16-rounded inputs, fp32
accumulation; the TPU's default), ``tf32`` (the tensor cores' fp32 mode,
10 mantissa bits; the trap of the precision rule), ``bf16x3`` (hi + lo bf16
limbs of both operands, three passes; the TPU's ``_dotx(split="both")`` and
HIGH) and ``fp32`` (CUDA-core FMA; HIGHEST). The probe's shapes are tiny, so
the kernel is bound by its launch latency.

:func:`precision_dot_plain` is each mode's plain version: the inputs rounded
as the mode rounds them (bf16 nearest-even; tf32 nearest with ties away, as
``cvt.rna`` does; the three limb products of ``bf16x3``), multiplied in
fp64. :func:`precision_dot` takes it only for CPU tensors (returned in
fp32); for CUDA tensors it launches the kernel or raises, and counts the
launch in ``precision_dot.launches``. :func:`run_probe` is the probe itself.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.ops import cuda_build

MODES = ("bf16", "tf32", "bf16x3", "fp32")


def probe_inputs() -> list:
    """The probe's three (name, a, b) fp32 pairs, made as the TPU script
    makes them (numpy ``default_rng(0)``): the encode-argument product
    (pts (256, 8) x bands (8, 128), up to 2^9), a one-hot relayout
    ((256, 128) x z (128, 128)) and the triangular cumsum ((16, 16) x
    log T (16, 128))."""
    rng = np.random.default_rng(0)
    Q, EP = 256, 128
    pts = rng.uniform(-2, 2, (Q, 8)).astype(np.float32)
    bands = np.zeros((8, EP), np.float32)
    bands[:3] = np.repeat(2.0 ** np.arange(0, 10), 13)[:EP][None].repeat(3, 0)
    oh = np.zeros((Q, 128), np.float32)
    oh[np.arange(Q), rng.integers(0, 128, Q)] = 1.0
    z = rng.uniform(2, 6, (128, 128)).astype(np.float32)
    tri = np.tril(np.ones((16, 16), np.float32), -1)
    lg = rng.uniform(-5, 0, (16, 128)).astype(np.float32)
    return [("encode args (pts@bands)", pts, bands),
            ("one-hot relayout (oh@z)", oh, z),
            ("tri cumsum (tri@logT)", tri, lg)]


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest bf16 (ties to even), back in fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest tf32 (10 mantissa bits, ties away from zero, as
    ``cvt.rna.tf32.f32``), back in fp32; inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(((bits >> 23) & 0xFF) == 0xFF, bits, r)
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(
        torch.float32)


def precision_dot_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """The product of fp32 ``a`` (M, K) and ``b`` (K, N) as ``mode`` rounds
    its inputs, computed in fp64 → (M, N) fp64."""
    a, b = a.float(), b.float()
    if mode == "bf16":
        return round_bf16(a).double() @ round_bf16(b).double()
    if mode == "tf32":
        return round_tf32(a).double() @ round_tf32(b).double()
    if mode == "bf16x3":
        ah, bh = round_bf16(a), round_bf16(b)
        al, bl = round_bf16(a - ah).double(), round_bf16(b - bh).double()
        ah, bh = ah.double(), bh.double()
        return ah @ bh + ah @ bl + al @ bh
    if mode == "fp32":
        return a.double() @ b.double()
    raise ValueError(f"mode {mode!r} is not one of {MODES}")


def _launch(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch K5 on the current stream (fp32 inputs on one CUDA device)."""
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError("precision_dot: both tensors must be on one CUDA device")
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    lib = cuda_build.load("precision_probe")
    fn = lib.nerf_precision_dot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), M, K, N, MODES.index(mode),
             ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "precision_probe kernel launch")
    precision_dot.launches += 1
    return out


def precision_dot(a: torch.Tensor, b: torch.Tensor, mode: str, *,
                  device=None) -> torch.Tensor:
    """``a @ b`` for fp32 ``a`` (M, K), ``b`` (K, N) in precision ``mode``
    (one of :data:`MODES`) → (M, N) fp32. Runs on ``cuda`` (the K5 kernel)
    unless ``device="cpu"`` (the plain version, rounded to fp32)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0] or 0 in a.shape + b.shape:
        raise ValueError(f"precision_dot: cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")
    dev = resolve_device(device)
    a, b = a.to(dev), b.to(dev)
    if dev.type == "cpu":
        return precision_dot_plain(a, b, mode).float()
    return _launch(a, b, mode)


precision_dot.launches = 0


def run_probe(device=None) -> list:
    """The probe: each of :func:`probe_inputs` in each mode through
    :func:`precision_dot` → rows of {shape, mode, out, oracle, max_abs,
    max_rel}; errors are against the fp64 product of the unrounded inputs,
    relative errors over max(|oracle|, 1e-30) as in the TPU script."""
    dev = resolve_device(device)
    rows = []
    for name, a_np, b_np in probe_inputs():
        a = torch.from_numpy(a_np).to(dev)
        b = torch.from_numpy(b_np).to(dev)
        oracle = a.double() @ b.double()
        for mode in MODES:
            out = precision_dot(a, b, mode, device=dev)
            err = (out.double() - oracle).abs()
            rel = err / oracle.abs().clamp(min=1e-30)
            rows.append(dict(shape=name, mode=mode, a=a, b=b, out=out,
                             oracle=oracle, max_abs=float(err.max()),
                             max_rel=float(rel.max())))
    return rows
