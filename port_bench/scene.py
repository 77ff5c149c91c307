"""The benchmark's scene: a Blender-format dataset drawn from an analytic
scene, in NumPy, and written with the standard library's ``zlib``.

Like the Blender ``lego`` scene the program is trained on: 100 training
views of 800x800 RGBA (transparent background), ``camera_angle_x`` 0.6911112
(focal 1111.1), cameras on the radius-4 sphere's upper half looking at the
origin (OpenGL axes). The content is three textured spheres inside the
[-1.2, 1.2] box, so that colours and opacity vary over every view.

The files are written once per checkout, into a directory under
``port_bench/.cache/`` named by a digest of the scene's parameters, and read
back by :func:`load` for the reference. The PNGs use filter type 0 on every
row, so that :func:`read_png` needs only ``zlib``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / ".cache"
PARAMS = {"version": 1, "views": 100, "height": 800, "width": 800,
          "camera_angle_x": 0.6911112070083618, "radius": 4.0, "scene_seed": 2020}
# (centre, radius, texture frequency, base colour)
SPHERES = (((0.0, 0.0, 0.0), 0.8, 9.0, (0.85, 0.35, 0.15)),
           ((0.9, -0.5, 0.3), 0.45, 14.0, (0.2, 0.55, 0.9)),
           ((-0.7, 0.6, -0.4), 0.5, 6.0, (0.3, 0.8, 0.35)))


def focal(p: dict = PARAMS) -> float:
    return 0.5 * p["width"] / np.tan(0.5 * p["camera_angle_x"])


def intrinsics(p: dict = PARAMS) -> np.ndarray:
    """(3, 3) pinhole K: the focal length from ``camera_angle_x``, the centre
    at the middle of the frame."""
    f, H, W = focal(p), p["height"], p["width"]
    return np.array([[f, 0.0, 0.5 * W], [0.0, f, 0.5 * H], [0.0, 0.0, 1.0]], np.float32)


def camera_poses(p: dict = PARAMS) -> np.ndarray:
    """(N, 4, 4) camera-to-world matrices on the upper half of the sphere."""
    rng = np.random.default_rng(p["scene_seed"])
    n = p["views"]
    theta = rng.uniform(0.0, 2.0 * np.pi, n)
    elev = np.arcsin(rng.uniform(0.05, 0.95, n))
    pos = p["radius"] * np.stack([np.cos(elev) * np.cos(theta),
                                  np.cos(elev) * np.sin(theta), np.sin(elev)], -1)
    poses = np.zeros((n, 4, 4))
    for i, c in enumerate(pos):
        back = c / np.linalg.norm(c)
        right = np.cross([0.0, 0.0, 1.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        poses[i, :3, :3] = np.stack([right, up, back], -1)
        poses[i, :3, 3] = c
        poses[i, 3, 3] = 1.0
    return poses.astype(np.float32)


def render_view(c2w: np.ndarray, p: dict = PARAMS) -> np.ndarray:
    """(H, W, 4) uint8: the spheres seen from ``c2w``, Lambertian-shaded,
    textured by position, over a transparent background."""
    H, W, f = p["height"], p["width"], focal(p)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64) + 0.5
    dirs = np.stack([(xs - 0.5 * W) / f, -(ys - 0.5 * H) / f, -np.ones_like(xs)], -1)
    d = dirs @ c2w[:3, :3].T.astype(np.float64)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3].astype(np.float64)
    best = np.full((H, W), np.inf)
    rgb = np.ones((H, W, 3))
    for centre, radius, freq, colour in SPHERES:
        oc = o - np.asarray(centre)
        b = d @ oc
        disc = b * b - (oc @ oc - radius * radius)
        hit = disc > 0
        t = np.where(hit, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
        near = hit & (t > 0) & (t < best)
        x = o + d * np.where(near, t, 0.0)[..., None]
        n = (x - np.asarray(centre)) / radius
        shade = 0.35 + 0.65 * np.clip(n @ np.array([0.3, 0.5, 0.81]), 0.0, 1.0)
        tex = 0.75 + 0.25 * np.sin(freq * x[..., 0]) * np.cos(freq * x[..., 1] + x[..., 2])
        col = np.clip(np.asarray(colour) * (shade * tex)[..., None], 0.0, 1.0)
        rgb = np.where(near[..., None], col, rgb)
        best = np.where(near, t, best)
    alpha = np.isfinite(best)
    out = np.zeros((H, W, 4), np.uint8)
    out[..., :3] = np.round(rgb * 255.0)
    out[..., 3] = np.where(alpha, 255, 0)
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: Path, img: np.ndarray) -> None:
    """An 8-bit RGBA PNG, filter type 0 on every row."""
    H, W, _ = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * 4)], 1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    path.write_bytes(data)


def read_png(path: Path) -> np.ndarray:
    """(H, W, 4) uint8 of a PNG that :func:`write_png` wrote."""
    data = Path(path).read_bytes()
    pos, idat, size = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    W, H = size
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + 4 * W)
    if np.any(rows[:, 0]):
        raise ValueError(f"{path}: a row with a PNG filter other than 0")
    return rows[:, 1:].reshape(H, W, 4)


def scene_dir(p: dict = PARAMS) -> Path:
    key = hashlib.sha1(json.dumps(p, sort_keys=True).encode()).hexdigest()[:12]
    return CACHE / f"scene-{key}"


def ensure(p: dict = PARAMS) -> Path:
    """The scene's directory, written first if this checkout has none."""
    root = scene_dir(p)
    if (root / "transforms_train.json").exists():
        return root
    tmp = root.with_name(root.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    (tmp / "train").mkdir(parents=True)
    poses = camera_poses(p)
    frames = []
    for i, c2w in enumerate(poses):
        write_png(tmp / "train" / f"r_{i}.png", render_view(c2w, p))
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (tmp / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": p["camera_angle_x"], "frames": frames}))
    try:
        os.rename(tmp, root)
    except OSError:                  # another process wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return root


def load(p: dict = PARAMS) -> dict:
    """The scene as arrays: ``images`` (N, H, W, 4) uint8, ``c2w`` (N, 3, 4),
    ``K`` (N, 3, 3), read from :func:`ensure`'s files."""
    root = ensure(p)
    meta = json.loads((root / "transforms_train.json").read_text())
    images = np.stack([read_png(root / (fr["file_path"] + ".png")) for fr in meta["frames"]])
    c2w = np.asarray([fr["transform_matrix"] for fr in meta["frames"]], np.float32)[:, :3]
    K = intrinsics(p)
    return {"images": images, "c2w": c2w, "K": np.repeat(K[None], len(images), 0)}
