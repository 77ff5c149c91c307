"""The port's host codecs against the libraries the JAX package calls:

* ``data/png.py`` against ``imageio.v2.imread`` (Pillow) on every colour
  type, bit depth and interlace method, bit for bit;
* the LLFF loader's gamma: a Pillow-written PNG with a ``gAMA`` chunk loads
  bit-equal through the port's loader and the JAX loader (which reads it
  with ``imageio.v2.imread(path, apply_gamma=True)``);
* ``data/jpeg.py`` against ``imageio.v2.imread`` (Pillow, libjpeg-turbo) on
  Pillow-written baseline JPEGs, bit for bit, and through both LLFF loaders
  (the other kinds: ``tests/test_torch_jpeg_*.py``);
* ``data/resize.py:area_resize`` against ``cv2.resize(..., INTER_AREA)``:
  uint8 bit for bit; float32 bit for bit at non-integer ratios and within
  3e-7 at whole ones (the block mean's order, ``tests/test_torch_loaders.py``);
* the README's Quickstart commands pass the port's config check.
"""

import re
import struct
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from nerf_sandbox_tpu.data.blender_loader import BlenderSceneLoader as JBlender
from nerf_sandbox_tpu.data.llff_loader import LLFFSceneLoader as JLLFF
from nerf_sandbox_tpu_torch import config as tcfg
from nerf_sandbox_tpu_torch.data.blender_loader import BlenderSceneLoader
from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
from nerf_sandbox_tpu_torch.data.llff_loader import LLFFSceneLoader
from nerf_sandbox_tpu_torch.data.png import png_gamma, read_png, read_pngs
from nerf_sandbox_tpu_torch.data.resize import area_resize
from nerf_sandbox_tpu_torch.scripts.train_nerf import resolve_config
from tests import torch_jpeg_writer as jw
from tests.test_loaders import _make_blender, _make_llff

ROOT = Path(__file__).resolve().parent.parent
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------- PNG

def _pack_rows(s, depth):
    """(h, w, ch) samples → (h, stride) bytes, big-endian, MSB-first bits."""
    flat = s.reshape(s.shape[0], -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(s.shape[0], -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        s.shape[0], -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filter(rows, bpp, filters):
    """Row y filtered with ``filters[y % len(filters)]`` (PNG section 9)."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for y in range(rows.shape[0]):
        cur = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        ft = filters[y % len(filters)]
        if ft == 4:
            p = left + prior - up_left
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, up_left))
        else:
            pred = [np.zeros_like(cur), left, prior, (left + prior) // 2][ft]
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(out)


def _chunk(t, data):
    return (struct.pack(">I", len(data)) + t + data
            + struct.pack(">I", zlib.crc32(t + data) & 0xFFFFFFFF))


def _make_png(path, samples, depth, color, interlace, palette=None):
    """A PNG of (H, W, ch) samples at any depth, Adam7 when ``interlace``,
    the five filters in turn."""
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    body = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            body += _filter(_pack_rows(sub, depth), bpp, (0, 1, 2, 3, 4))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    Path(path).write_bytes(data + _chunk(b"IDAT", zlib.compress(body))
                           + _chunk(b"IEND", b""))


PNG_KINDS = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                                  4: (8, 16), 6: (8, 16)}.items() for d in ds]


@pytest.mark.parametrize("interlace", [0, 1], ids=["flat", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_KINDS, ids=[f"c{c}d{d}" for c, d in PNG_KINDS])
def test_png_depths_and_interlace_equal_imageio(tmp_path, color, depth, interlace):
    """Every colour type and bit depth, non-interlaced and Adam7, at shapes
    that leave passes empty (1x1, 3x5) and rows with partial bytes: the
    arrays (dtype, shape, values) are ``imageio.v2.imread``'s: 1-bit gray
    as bool, 2/4-bit gray scaled, 16-bit gray uint16, 16-bit colour as its
    high bytes, 16-bit gray + alpha as RGBA."""
    rng = np.random.default_rng(color * 100 + depth * 2 + interlace)
    for k, shape in enumerate(((1, 1), (3, 5), (13, 11), (17, 33))):
        hi = min(1 << depth, 7) if color == 3 else 1 << depth
        s = rng.integers(0, hi, shape + (CHANNELS[color],))
        pal = rng.integers(0, 256, (7, 3)) if color == 3 else None
        p = tmp_path / f"t{k}.png"
        _make_png(p, s, depth, color, interlace, pal)
        want, got = imageio.imread(p), read_png(p)
        assert got.dtype == want.dtype and got.shape == want.shape, (shape, got.dtype)
        assert np.array_equal(got, want), shape


def test_pillow_written_low_and_high_depth_pngs(tmp_path):
    """Pillow's own 1-bit gray, 2- and 4-bit palette and 16-bit gray files,
    decoded in one ``read_pngs`` call beside an 8-bit one."""
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 2, (9, 21)).astype(bool)).save(tmp_path / "b.png")
    for bits, n in ((2, 4), (4, 13)):
        im = Image.fromarray(rng.integers(0, n, (9, 21)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).tolist())
        im.save(tmp_path / f"p{bits}.png", bits=bits)
    Image.fromarray(rng.integers(0, 65536, (9, 21)).astype(np.uint16)).save(
        tmp_path / "g16.png")
    Image.fromarray(rng.integers(0, 256, (9, 21, 3)).astype(np.uint8)).save(
        tmp_path / "rgb.png")
    paths = [tmp_path / f for f in ("b.png", "p2.png", "p4.png", "g16.png", "rgb.png")]
    for p, got in zip(paths, read_pngs(paths)):
        want = imageio.imread(p)
        assert got.dtype == want.dtype and np.array_equal(got, want), p


# ---------------------------------------------------------------- gamma

def _gamma_png(path, img, gamma=45455):
    info = PngImagePlugin.PngInfo()
    info.add(b"gAMA", struct.pack(">I", gamma))
    Image.fromarray(img).save(path, pnginfo=info)


def test_gamma_png_loads_like_the_jax_loader(tmp_path):
    """ImageMagick writes a gAMA chunk by default: an LLFF folder of
    Pillow-written PNGs with gAMA 0.45455 (and one without) loads bit-equal
    through both loaders, and ``png_gamma`` reads the value Pillow reads."""
    root = _make_llff(tmp_path / "fern", n=4, H=8, W=12)
    files = sorted((root / "images").glob("*.png"))
    for i, p in enumerate(files[:3]):
        _gamma_png(p, read_png(p), gamma=(45455, 100000, 220000)[i])
        assert png_gamma(p) == Image.open(p).info["gamma"]
    assert png_gamma(files[3]) is None
    port, ref = LLFFSceneLoader(root), JLLFF(root)
    for split in ("train", "test"):
        a, b = port.load(split), ref.load(split)
        assert len(a.frames) == len(b.frames)
        for fa, fb in zip(a.frames, b.frames):
            assert fa.image.dtype == fb.image.dtype and np.array_equal(fa.image, fb.image)
    raw = read_png(files[0]).astype(np.float64)
    want = np.round(((raw / 255.0) ** 0.45455) * 255.0 + 0.4999).astype(np.uint8)
    got = port.load("train").frames[0].image
    assert np.array_equal(got, want.astype(np.float32) / 255.0)


# ---------------------------------------------------------------- JPEG

def _synth(H, W, C, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c)
                    for c in range(C)], -1) + rng.normal(0, 12, (H, W, C))
    return np.clip(img, 0, 255).astype(np.uint8)


JPEG_CASES = [(sub, q, ri, shape) for sub in (0, 1, 2) for q, ri in ((75, 0), (95, 2))
              for shape in ((37, 50), (16, 16))] + [(2, 100, 1, (1, 1)), (2, 30, 0, (9, 3))]


@pytest.mark.parametrize("sub,quality,restart,shape", JPEG_CASES,
                         ids=[f"s{a}-q{b}-r{c}-{d[0]}x{d[1]}" for a, b, c, d in JPEG_CASES])
def test_jpeg_equals_imageio(tmp_path, sub, quality, restart, shape):
    """Pillow-written baseline JPEGs: 4:4:4, 4:2:2 and 4:2:0, with and
    without restart intervals, at sizes that leave partial MCUs and chroma
    planes 1-2 samples wide: bit-equal to ``imageio.v2.imread``."""
    img = _synth(*shape, 3, seed=sub * 7 + quality)
    p = tmp_path / "t.jpg"
    kw = {"quality": quality, "subsampling": sub}
    if restart:
        kw["restart_marker_blocks"] = restart
    Image.fromarray(img).save(p, **kw)
    want, got = imageio.imread(p), read_jpeg(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_gray_jpeg_and_the_unsupported_kinds(tmp_path):
    """A gray file equals imageio's; kinds imageio refuses (12-bit,
    hierarchical) and a cut file raise, naming the file."""
    img = _synth(21, 30, 1, seed=3)[..., 0]
    Image.fromarray(img).save(tmp_path / "g.jpg", quality=85)
    want, got = imageio.imread(tmp_path / "g.jpg"), read_jpeg(tmp_path / "g.jpg")
    assert got.shape == want.shape and np.array_equal(got, want)
    img = _synth(16, 16, 3, 4)
    comps = jw.dct_components([img[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)])
    for name, kw, what in (("b12.jpg", {"precision": 12}, "12-bit"),
                           ("sof5.jpg", {"sof": 0xC5}, "hierarchical")):
        jw.write_jpeg(tmp_path / name, comps, 16, 16, **kw)
        with pytest.raises(Exception):
            imageio.imread(tmp_path / name)
        with pytest.raises(ValueError, match=f"{name}: {what} .*refuses it too"):
            read_jpeg(tmp_path / name)
    (tmp_path / "cut.jpg").write_bytes((tmp_path / "g.jpg").read_bytes()[:200])
    with pytest.raises(ValueError, match="cut.jpg"):
        read_jpeg(tmp_path / "cut.jpg")


def test_llff_jpeg_scene_loads_like_the_jax_loader(tmp_path):
    """``--downscale 1`` reads ``images/``, JPEGs in the public LLFF scenes."""
    root = _make_llff(tmp_path / "fern", n=4, H=24, W=32)
    for i, p in enumerate(sorted((root / "images").glob("*.png"))):
        Image.fromarray(_synth(24, 32, 3, i)).save(p.with_suffix(".jpg"), quality=90)
        p.unlink()
    port, ref = LLFFSceneLoader(root), JLLFF(root)
    for split in ("train", "test"):
        for fa, fb in zip(port.load(split).frames, ref.load(split).frames):
            assert np.array_equal(fa.image, fb.image)


# ---------------------------------------------------------------- INTER_AREA

AREA_CASES = [((800, 800), (512, 512)), ((800, 800), (266, 266)),
              ((63, 63), (17, 17)), ((63, 40), (13, 17)), ((800, 800), (200, 200)),
              ((20, 20), (5, 10))]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("src,dst", AREA_CASES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in AREA_CASES])
def test_area_resize_against_cv2(src, dst, dtype):
    """Gray, RGB and RGBA: uint8 bit for bit at every ratio (cv2's integer
    path rounds (sum + 2) >> 2 at 2 x 2 and half to even elsewhere);
    float32 bit for bit at non-integer ratios (cv2's overlap weights and
    order) and within 3e-7 at whole ones (the block mean)."""
    rng = np.random.default_rng(src[0] + dst[0])
    whole = src[0] % dst[1] == 0 and src[1] % dst[0] == 0
    for ch in (None, 3, 4):
        shape = src + ((ch,) if ch else ())
        img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == "uint8"
               else rng.random(shape, dtype=np.float32))
        want = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
        got = area_resize(img, dst)
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == "float32" and whole:
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-7)
        else:
            assert np.array_equal(got, want), ch


@pytest.mark.parametrize("factor", [3, 5])
def test_blender_downscale_at_a_partial_block_equals_jax(tmp_path, factor):
    """``--downscale 3`` of a frame it does not divide (16 → 5) no longer
    raises: the RGBA frames equal the JAX loader's cv2 ``INTER_AREA``."""
    root = _make_blender(tmp_path / "s", n_frames=2, size=16, rgba=True)
    got = BlenderSceneLoader(root, downscale=factor).load("train")
    want = JBlender(root, downscale=factor).load("train")
    for a, b in zip(got.frames, want.frames):
        assert a.image.shape == b.image.shape and np.array_equal(a.image, b.image)
        assert np.array_equal(a.K, b.K)


# ---------------------------------------------------------------- README

def _quickstart_commands():
    """The README's Quickstart commands for a named dataset kind (Blender
    and fern), as argv lists."""
    text = (ROOT / "README.md").read_text()
    block = text.split("## Quickstart", 1)[1].split("```bash", 1)[1].split("```", 1)[0]
    lines = re.sub(r"\\\n\s*", " ", block).splitlines()
    return [ln.split()[3:] for ln in lines
            if ln.startswith("python -m nerf_sandbox_tpu.scripts.train_nerf")
            and "--data_kind" in ln]


def test_readme_quickstart_commands_pass_the_check(tmp_path):
    """Both Quickstart commands (Blender with ``--use_tb --render_path_after
    --progress_video_during_training``, fern with ``--downscale 8 --use_ndc
    ... --use_tb``) resolve in the port and pass ``check_ported_config``."""
    cmds = _quickstart_commands()
    assert len(cmds) == 2 and all("--use_tb" in c for c in cmds)
    roots = {"blender": _make_blender(tmp_path / "b", n_frames=2, size=8),
             "llff": _make_llff(tmp_path / "l", n=4, H=8, W=8)}
    for argv in cmds:
        kind = argv[argv.index("--data_kind") + 1]
        argv[argv.index("--data_root") + 1] = str(roots[kind])
        argv[argv.index("--out_dir") + 1] = str(tmp_path / f"out_{kind}")
        cfg = resolve_config(argv)
        tcfg.check_ported_config(cfg)
        assert cfg.use_tb and cfg.vanilla
