"""Device selection and precision policy for the port.

There is deliberately no "cuda if present, else cpu" helper: an entry point
runs on ``cuda`` unless its caller asks for the CPU, and raises when no CUDA
device exists. A timing or a kernel result can then never come silently
from the CPU.

Precision (ROADMAP precision rule): fp32 matrix products stay true fp32 —
TF32 is switched off explicitly for cuBLAS and cuDNN rather than trusting
the defaults — and bf16 products accumulate in fp32 (no reduced-precision
split-K reductions). Encode arguments, sample placement and compositing are
fp32 throughout the package; only the MLP runs in bf16.
"""

from __future__ import annotations

import torch


def _init_cuda() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        _init_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
