"""Blender synthetic dataset loader, in numpy.

Port of ``nerf_sandbox_tpu/data/blender_loader.py`` (kept as a copy because
the JAX package's ``data/__init__.py`` imports JAX), reading its PNGs with
``data/png.py`` instead of ``imageio``. Parity target of both:
``nerf_sandbox/source/data/loaders/blender_loader.py:17-140``:

* parse ``transforms_{split}.json``; strict ``<root>/<file_path>.png``
  resolution (raises FileNotFoundError with the offending paths)
* K from ``camera_angle_x``: f = 0.5·W / tan(θ/2), cx = W/2, cy = H/2
* integer downscale: cv2's INTER_AREA in the JAX package; here its numpy
  counterpart ``data/resize.py:area_resize`` (a block mean where the factor
  divides the frame: bit-equal for RGBA frames at factors 2 and 4, within
  3e-7 elsewhere, ``tests/test_torch_loaders.py``; cv2's overlap weights
  where it does not, bit-equal, ``tests/test_torch_codecs.py``)
* optional mean-translation centering (``centering="auto"``) and uniform
  ``scene_scale`` multiplier on camera translations
* camera convention: OpenGL (+X right, +Y up, looks -Z)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List

import numpy as np

from nerf_sandbox_tpu_torch.data.png import read_pngs
from nerf_sandbox_tpu_torch.data.resize import area_resize
from nerf_sandbox_tpu_torch.data.scene import Frame, Scene


def area_downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """(H, W[, C]) → float32 (H // factor, W // factor[, C]), the JAX
    loader's ``cv2.resize(img, (W // factor, H // factor), INTER_AREA)``
    (:func:`area_resize`: a block mean where ``factor`` divides the frame,
    the partial pixels weighted by their overlap where it does not)."""
    f = int(factor)
    H, W = img.shape[:2]
    return area_resize(img.astype(np.float32), (W // f, H // f))


class BlenderSceneLoader:
    camera_convention = "opengl"

    def __init__(self, root, downscale: int = 1, white_bkgd: bool = True, *,
                 centering: str = "none", scene_scale: float = 1.0) -> None:
        self.root = Path(root)
        self.downscale = int(downscale)
        self.white_bkgd = bool(white_bkgd)
        self.centering = str(centering)
        self.scene_scale = float(scene_scale)

    # ---------- internals ----------

    def _to_float(self, img: np.ndarray) -> np.ndarray:
        img = img.astype(np.float32) / 255.0
        return area_downscale(img, self.downscale) if self.downscale > 1 else img

    @staticmethod
    def _intrinsics(W: int, H: int, camera_angle_x: float) -> np.ndarray:
        f = 0.5 * W / np.tan(0.5 * camera_angle_x)
        return np.array([[f, 0.0, 0.5 * W],
                         [0.0, f, 0.5 * H],
                         [0.0, 0.0, 1.0]], dtype=np.float32)

    def _resolve_image_path(self, file_path: str) -> Path:
        p = Path(file_path)
        target = (p if p.is_absolute() else (self.root / p)).with_suffix(".png")
        target = target.resolve()
        if not target.exists():
            raise FileNotFoundError(
                f"Image file not found: file_path={file_path!r} "
                f"root={self.root} expected={target}")
        return target

    # ---------- public API ----------

    def load(self, split: str = "train", image_filter=None) -> Scene:
        """Every frame of the split. ``image_filter(i, n) -> bool``: the
        frames it rejects keep their pose and K but get a zero image, not
        decoded (``--shard_scene`` under several processes, where each
        process decodes only the frames its ranks own); frame 0 is always
        decoded, as the JAX loader's shape probe."""
        tf_path = self.root / f"transforms_{split}.json"
        if not tf_path.exists():
            raise FileNotFoundError(f"Could not find transforms file: {tf_path}")
        meta = json.loads(tf_path.read_text())

        frames_meta = meta["frames"]
        n_split = len(frames_meta)
        keep = [i for i in range(n_split)
                if i == 0 or image_filter is None or image_filter(i, n_split)]
        paths = [self._resolve_image_path(frames_meta[i]["file_path"]) for i in keep]
        decoded = dict(zip(keep, (self._to_float(img) for img in read_pngs(paths))))
        images = [decoded[i] if i in decoded else np.zeros(decoded[0].shape, np.float32)
                  for i in range(n_split)]
        H, W = images[0].shape[:2]
        K = self._intrinsics(W, H, float(meta["camera_angle_x"]))
        c2ws = np.stack([np.array(fr["transform_matrix"], dtype=np.float32)
                         for fr in frames_meta], axis=0)    # (N, 4, 4)
        if self.centering == "auto" and len(c2ws):
            c2ws[:, :3, 3] -= c2ws[:, :3, 3].mean(axis=0)
        if self.scene_scale != 1.0:
            c2ws[:, :3, 3] *= self.scene_scale

        # D-NeRF-format per-frame "time" (dynamic scenes): pass through as
        # Frame.time; absent = static (None)
        times = [fr.get("time") for fr in frames_meta]
        frames: List[Frame] = [
            Frame(image=img, K=K.copy(), c2w=c2w,
                  time=None if t is None else float(t))
            for img, c2w, t in zip(images, c2ws, times)
        ]
        return Scene(frames=frames, white_bkgd=self.white_bkgd)
