"""The port's PNG I/O (``data/png.py``) and its Blender and LLFF loaders
against ``imageio`` and the JAX package's loaders, on the CPU.

* ``read_png`` is bit-equal to ``imageio.v2.imread`` on every scene the
  repo's generators write (``tests/make_*_scene.py``,
  ``tests/test_loaders.py:_make_blender/_make_llff``), on random gray, gray
  + alpha, RGB, RGBA and palette images written by Pillow, and on files
  whose rows use each of the five PNG filters (written here, decoded by
  both readers); ``read_pngs`` decodes a list of such files of mixed shapes
  in batches, in order; ``write_png`` round-trips through both readers.
* The loaders equal the JAX loaders bit for bit (images, K, c2w, times,
  splits, LLFF bounds), and so is the Blender integer downscale (cv2's
  INTER_AREA against the port's block mean) for RGBA frames at factors 2
  and 4; cv2's other paths add in other orders, held at 3e-7.
"""

import json
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_sandbox_tpu.data.blender_loader import BlenderSceneLoader as JBlender
from nerf_sandbox_tpu.data.llff_loader import LLFFSceneLoader as JLLFF
from nerf_sandbox_tpu_torch.data.blender_loader import (
    BlenderSceneLoader, area_downscale)
from nerf_sandbox_tpu_torch.data.llff_loader import LLFFSceneLoader
from nerf_sandbox_tpu_torch.data import png as png_mod
from nerf_sandbox_tpu_torch.data.png import png_gamma, read_png, read_pngs, write_png
from tests import make_360_scene, make_dynamic_scene, make_llff_scene, make_sphere_scene
from tests import torch_jpeg_writer as jw
from tests.test_loaders import _make_blender, _make_llff


def _pngs(root):
    return sorted(root.rglob("*.png"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Every scene generator of the repo, at a small size."""
    d = tmp_path_factory.mktemp("scenes")
    return {
        "sphere": make_sphere_scene.make_scene(d / "sphere", views=3, size=16,
                                               val_views=1),
        "sphere_textured": make_sphere_scene.make_scene(
            d / "sphere_t", views=2, size=16, textured=True, val_views=1,
            exposure_jitter=0.2),
        "llff": make_llff_scene.make_llff_scene(d / "llff", views=4, size=16),
        "360": make_360_scene.make_scene(d / "360", views=3, size=16, val_views=1),
        "dynamic": make_dynamic_scene.make_scene(d / "dyn", views=3, size=16,
                                                 val_views=1),
        "blender_rgb": _make_blender(d / "blender", n_frames=3, size=16),
        "blender_rgba": _make_blender(d / "blender4", n_frames=3, size=16, rgba=True),
        "llff_small": _make_llff(d / "fern", n=5, H=12, W=16),
    }


@pytest.mark.parametrize("name", ["sphere", "sphere_textured", "llff", "360",
                                  "dynamic", "blender_rgb", "blender_rgba",
                                  "llff_small"])
def test_read_png_equals_imageio_on_generated_scenes(scenes, name):
    files = _pngs(scenes[name])
    assert files
    for p in files:
        want = imageio.imread(p)
        got = read_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape, p
        assert np.array_equal(got, want), p


@pytest.mark.parametrize("mode,shape", [("L", (9, 13)), ("LA", (9, 13, 2)),
                                        ("RGB", (9, 13, 3)), ("RGBA", (9, 13, 4)),
                                        ("RGB", (64, 48, 3)), ("RGBA", (33, 70, 4))])
def test_read_png_equals_imageio_on_random_images(tmp_path, mode, shape):
    """Pillow picks each row's filter adaptively, so noise and smooth
    gradients exercise several filter types."""
    rng = np.random.default_rng(hash((mode, shape)) % 2**32)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = ((yy * 7 + xx * 3) % 256).astype(np.uint8)
    smooth = np.broadcast_to(smooth[..., None], shape[:2] + (shape[2:] or (1,)))
    for k, img in enumerate((noise, np.ascontiguousarray(smooth).reshape(shape))):
        p = tmp_path / f"{mode}_{k}.png"
        Image.fromarray(img, mode=mode).save(p)
        assert np.array_equal(read_png(p), imageio.imread(p))
        assert np.array_equal(read_png(p), img)


@pytest.mark.parametrize("transparent", [False, True])
def test_read_png_palette_images(tmp_path, transparent):
    rng = np.random.default_rng(5)
    rgb = Image.fromarray(rng.integers(0, 256, (11, 17, 3), dtype=np.uint8))
    pal = rgb.convert("P", palette=Image.ADAPTIVE, colors=256)
    assert pal.getpalette() is not None
    p = tmp_path / "pal.png"
    if transparent:
        pal.save(p, transparency=bytes(range(0, 250, 10)))
    else:
        pal.save(p)
    got, want = read_png(p), imageio.imread(p)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape[-1] == 3     # imageio drops a palette's tRNS alphas


def _filtered_png(path, img, filters):
    """An 8-bit PNG whose row y uses filter ``filters[y % len(filters)]``."""
    H, W, C = img.shape
    bpp, rows, prior = C, [], np.zeros(W * C, np.int64)
    for y in range(H):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(t, data):
        return struct.pack(">I", len(data)) + t + data + struct.pack(
            ">I", zlib.crc32(t + data) & 0xFFFFFFFF)
    ct = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ct, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_read_png_every_filter_type(tmp_path, channels, filters):
    rng = np.random.default_rng(channels * 10 + len(filters))
    img = rng.integers(0, 256, (7, 9, channels), dtype=np.uint8)
    p = tmp_path / "f.png"
    _filtered_png(p, img, filters)
    want = img[..., 0] if channels == 1 else img
    assert np.array_equal(imageio.imread(p), want)
    assert np.array_equal(read_png(p), want)


@pytest.mark.parametrize("group_samples", [1, 6 * 9 * 4 * 2, png_mod._WAVEFRONT_SAMPLES])
def test_read_pngs_decodes_mixed_lists_in_order(tmp_path, monkeypatch, group_samples):
    """Frames of one shape that use average or Paeth rows decode together,
    ``group_samples`` samples at a time; the others row by row."""
    monkeypatch.setattr(png_mod, "_WAVEFRONT_SAMPLES", group_samples)
    rng = np.random.default_rng(group_samples)
    want, paths = [], []
    for k, (shape, filters) in enumerate([
            ((6, 9, 4), (4, 3)), ((6, 9, 4), (0, 1, 2)), ((6, 9, 4), (3, 4, 1)),
            ((5, 7, 3), (4,)), ((6, 9, 4), (2, 4, 0, 3)), ((6, 9, 1), (3,)),
            ((6, 9, 4), (4,))]):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        paths.append(tmp_path / f"m{k}.png")
        _filtered_png(paths[-1], img, filters)
        want.append(img[..., 0] if shape[-1] == 1 else img)
    got = read_pngs(paths)
    assert len(got) == len(want)
    for p, g, w in zip(paths, got, want):
        assert np.array_equal(g, imageio.imread(p)) and np.array_equal(g, w), p


@pytest.mark.parametrize("shape", [(5, 6), (5, 6, 2), (5, 6, 3), (5, 6, 4), (800, 8, 4)])
def test_write_png_round_trips_through_both_readers(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "w.png"
    write_png(p, img)
    assert np.array_equal(imageio.imread(p), img)
    assert np.array_equal(read_png(p), img)
    assert png_gamma(p) is None


def _with_ihdr_byte(src, dst, offset, value):
    """A copy of ``src`` with IHDR byte ``offset`` (of the file) set."""
    data = bytearray(src.read_bytes())
    data[offset] = value
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    dst.write_bytes(bytes(data))


def test_unsupported_pngs_raise_naming_the_file(tmp_path):
    """Interlaced and 16-bit files decode (``tests/test_torch_codecs.py``);
    an unknown interlace method and a bit depth the colour type does not
    allow raise, naming the file."""
    img = np.zeros((4, 4, 3), np.uint8)
    p = tmp_path / "plain.png"
    write_png(p, img)
    _with_ihdr_byte(p, tmp_path / "interlaced.png", 28, 2)   # interlace method
    with pytest.raises(ValueError, match="interlaced.png.*interlace method 2"):
        read_png(tmp_path / "interlaced.png")
    _with_ihdr_byte(p, tmp_path / "deep.png", 24, 4)         # 4-bit RGB
    with pytest.raises(ValueError, match="deep.png.*bit depth 4"):
        read_png(tmp_path / "deep.png")


def _with_gamma(src, dst):
    """Insert a gAMA chunk after IHDR."""
    data = src.read_bytes()
    g = struct.pack(">I", 45455)
    chunk = (struct.pack(">I", 4) + b"gAMA" + g
             + struct.pack(">I", zlib.crc32(b"gAMA" + g) & 0xFFFFFFFF))
    dst.write_bytes(data[:33] + chunk + data[33:])


def test_gamma_chunk_detection_matches_the_jax_loader(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (4, 5, 3), dtype=np.uint8)
    plain, gamma = tmp_path / "plain.png", tmp_path / "gamma.png"
    write_png(plain, img)
    _with_gamma(plain, gamma)
    for p in (plain, gamma):
        assert (png_gamma(p) is not None) == JLLFF._png_has_gamma_chunk(p)
    assert png_gamma(gamma) == 0.45455 and np.array_equal(read_png(gamma), img)


def _same_scene(a, b, *, image_atol=0.0):
    """Frames, intrinsics, poses, times and metadata equal (images within
    ``image_atol`` where it is not 0)."""
    assert len(a.frames) == len(b.frames)
    assert a.white_bkgd == b.white_bkgd
    for fa, fb in zip(a.frames, b.frames):
        assert fa.image.dtype == fb.image.dtype and fa.image.shape == fb.image.shape
        if image_atol:
            np.testing.assert_allclose(fa.image, fb.image, rtol=0, atol=image_atol)
        else:
            assert np.array_equal(fa.image, fb.image)
        for k in ("K", "c2w"):
            assert np.array_equal(getattr(fa, k), getattr(fb, k)), k
            assert getattr(fa, k).dtype == getattr(fb, k).dtype, k
        assert fa.time == fb.time
        assert fa.meta == fb.meta


@pytest.mark.parametrize("name,kw", [
    ("sphere", {}), ("sphere_textured", {}), ("360", {"scene_scale": 0.25}),
    ("dynamic", {}), ("blender_rgb", {"centering": "auto"}),
    ("blender_rgba", {"white_bkgd": False})])
def test_blender_loader_equals_jax(scenes, name, kw):
    root = scenes[name]
    splits = [s for s in ("train", "val", "test") if (root / f"transforms_{s}.json").exists()]
    for split in splits:
        _same_scene(BlenderSceneLoader(root, **kw).load(split),
                    JBlender(root, **kw).load(split))
    with pytest.raises(FileNotFoundError):
        BlenderSceneLoader(root).load("nosuchsplit")


@pytest.mark.parametrize("name,factor,atol", [
    ("blender_rgba", 2, 0.0), ("blender_rgba", 4, 0.0),
    ("blender_rgb", 2, 3e-7), ("blender_rgb", 4, 3e-7), ("blender_rgba", 8, 3e-7)])
def test_blender_downscale_against_cv2(scenes, name, factor, atol):
    """INTER_AREA at an integer ratio averages each block, adding in an
    order that depends on cv2's code path: the port's order (row sums, top
    to bottom) is cv2's for RGBA at factors 2 and 4, bit for bit; elsewhere
    the sums differ in the last bits, measured at most 3.0e-7 (2.5 float32
    ulps of 1.0, RGBA at factor 8)."""
    root = scenes[name]
    got = BlenderSceneLoader(root, downscale=factor).load("train")
    want = JBlender(root, downscale=factor).load("train")
    diff = max(float(np.abs(a.image - b.image).max())
               for a, b in zip(got.frames, want.frames))
    assert diff <= atol, diff
    _same_scene(got, want, image_atol=atol)


def test_area_downscale_refuses_partial_blocks():
    """A frame the factor does not divide (10 x 9 at 2, 17 x 13 at 3)
    leaves partial blocks, which ``area_downscale`` weights as the JAX
    loader's ``cv2.resize(..., INTER_AREA)`` does, bit for bit."""
    rng = np.random.default_rng(0)
    for shape, f in (((10, 9, 3), 2), ((17, 13, 4), 3), ((17, 13), 3)):
        img = rng.random(shape, dtype=np.float32)
        want = cv2.resize(img, (shape[1] // f, shape[0] // f), interpolation=cv2.INTER_AREA)
        got = area_downscale(img, f)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), shape


@pytest.mark.parametrize("name,kw", [
    ("llff", {}), ("llff_small", {}), ("llff_small", {"use_llff_holdout": False}),
    ("llff_small", {"holdout_every": 2, "holdout_offset": 1}),
    ("llff_small", {"bd_factor": 0.5, "white_bkgd": False})])
def test_llff_loader_equals_jax(scenes, name, kw):
    root = scenes[name]
    port, ref = LLFFSceneLoader(root, **kw), JLLFF(root, **kw)
    for split in ("train", "test"):
        _same_scene(port.load(split), ref.load(split))
    assert port.norm_scale == ref.norm_scale
    for pct in ((5.0, 95.0), (0.0, 100.0)):
        assert port.get_global_near_far(pct) == ref.get_global_near_far(pct)


def test_llff_minified_folder_equals_jax(tmp_path):
    root = _make_llff(tmp_path / "fern", n=4, H=12, W=16)
    (root / "images_2").mkdir()
    for p in sorted((root / "images").glob("*.png")):
        write_png(root / "images_2" / p.name, read_png(p)[::2, ::2])
    for split in ("train", "test"):
        _same_scene(LLFFSceneLoader(root, downscale=2).load(split),
                    JLLFF(root, downscale=2).load(split))


def test_llff_gamma_and_jpeg_raise_naming_the_file(tmp_path):
    """A gAMA PNG and a progressive JPEG load as the JAX loader loads them
    (``tests/test_torch_codecs.py``, ``tests/test_torch_jpeg_*.py``); a JPEG
    imageio refuses (12-bit) and a damaged one raise, naming the file."""
    root = _make_llff(tmp_path / "fern", n=3, H=8, W=8)
    first = sorted((root / "images").glob("*.png"))[0]
    _with_gamma(first, first)
    for split in ("train", "test"):
        _same_scene(LLFFSceneLoader(root).load(split), JLLFF(root).load(split))
    img = np.asarray(Image.open(first).convert("RGB"))
    Image.fromarray(img).save(root / "images" / "img_000.jpg", progressive=True)
    first.unlink()
    for split in ("train", "test"):
        _same_scene(LLFFSceneLoader(root).load(split), JLLFF(root).load(split))
    jw.write_jpeg(root / "images" / "img_000.jpg",
                  jw.dct_components([img[..., i] for i in range(3)], [(1, 1)] * 3), 8, 8,
                  precision=12)
    with pytest.raises(ValueError, match="img_000.jpg: 12-bit JPEG.*refuses it too"):
        LLFFSceneLoader(root).load("train")
    (root / "images" / "img_000.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="img_000.jpg"):
        LLFFSceneLoader(root).load("train")


def test_blender_transforms_parse_like_jax(tmp_path):
    """Absolute and relative file paths, a per-frame time, a missing image."""
    root = _make_blender(tmp_path / "s", n_frames=2, size=8)
    meta = json.loads((root / "transforms_train.json").read_text())
    meta["frames"][1]["file_path"] = str(root / "train" / "r_1")
    meta["frames"][0]["time"] = 0.25
    (root / "transforms_train.json").write_text(json.dumps(meta))
    _same_scene(BlenderSceneLoader(root).load("train"), JBlender(root).load("train"))
    (root / "train" / "r_1.png").unlink()
    with pytest.raises(FileNotFoundError, match="r_1"):
        BlenderSceneLoader(root).load("train")
