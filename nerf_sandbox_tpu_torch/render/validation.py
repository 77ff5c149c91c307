"""Image-quality metrics (the PSNR of ``render/validation.py``).

Only ``compute_psnr`` is ported so far; the validation and progress-video
engine is ROADMAP queue 1, P6.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def compute_psnr(pred: np.ndarray, gt: np.ndarray,
                 mask: Optional[np.ndarray] = None) -> float:
    """PSNR over (H,W,3) images in [0,1]; optional (H,W,1) validity mask
    (reference validation_renderer.py:171-196)."""
    pred = np.clip(pred, 0.0, 1.0).astype(np.float64)
    gt = np.clip(gt, 0.0, 1.0).astype(np.float64)
    if mask is not None:
        m = mask.astype(np.float64)
        if m.ndim == 2:
            m = m[..., None]
        mse = float((((pred - gt) ** 2) * m).sum()
                    / max((m.sum() * pred.shape[-1]), 1e-8))
    else:
        mse = float(((pred - gt) ** 2).mean())
    return float(-10.0 * np.log10(max(mse, 1e-10)))
