"""Frame / Scene records (host-side, numpy).

A copy of ``nerf_sandbox_tpu/data/scene.py`` (reference
``nerf_sandbox/source/data/scene.py:27-110``), kept here because the JAX
package's ``data/__init__.py`` imports JAX. Same record semantics: image
HxWx{3|4}, K 3x3, c2w 3x4/4x4, optional mask, per-frame meta; scene-wide
white_bkgd/aabb/near/far/scale/origin. Device placement belongs to
``SceneArrays`` (``data/sampler.py``), not to the records.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class Frame:
    """A single calibrated view.

    image: HxWx{3|4} RGB(A), uint8 in [0,255] or float in [0,1].
    K:     (3,3) pinhole intrinsics.
    c2w:   (4,4) or (3,4) camera-to-world transform.
    mask:  optional HxW foreground mask.
    meta:  arbitrary per-frame metadata.
    time:  normalised capture time in [0, 1] of a dynamic scene; None for a
           static frame (treated as t = 0).
    """

    image: np.ndarray
    K: np.ndarray
    c2w: np.ndarray
    mask: Optional[np.ndarray] = None
    dist: Optional[Dict[str, float]] = None
    meta: Dict[str, Union[float, int, str]] = field(default_factory=dict)
    time: Optional[float] = None

    @property
    def H(self) -> int:
        return int(self.image.shape[0])

    @property
    def W(self) -> int:
        return int(self.image.shape[1])

    def c2w_3x4(self) -> np.ndarray:
        return np.asarray(self.c2w, np.float32)[:3, :4]


@dataclass
class Scene:
    """A collection of frames with scene-level metadata."""

    frames: List[Frame]
    white_bkgd: bool = True
    aabb: Optional[Tuple[float, float, float, float, float, float]] = None
    near: Optional[float] = None
    far: Optional[float] = None
    scale: float = 1.0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def H(self) -> int:
        return self.frames[0].H

    @property
    def W(self) -> int:
        return self.frames[0].W

    def __len__(self) -> int:
        return len(self.frames)
