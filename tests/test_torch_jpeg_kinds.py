"""``nerf_sandbox_tpu_torch/data/jpeg.py`` against ``imageio.v2.imread``
(Pillow 12, libjpeg-turbo 3.1) on the DCT kinds past baseline, bit for bit
in value, dtype and shape:

* sequential and progressive, Huffman- and arithmetic-coded files written
  by ``tests/torch_jpeg_writer.py`` at every whole sampling layout (4:4:4,
  4:2:2, 4:2:0, 4:4:0, 4:1:1, 3x1, 1x4, chroma sampled above luma, mixed),
  at sizes that leave partial MCUs and chroma planes 1-2 samples wide, with
  and without restart intervals;
* the writer itself, independently of the port: Pillow's decode of each
  arithmetic-coded file equals Pillow's decode of the Huffman-coded file
  with the same coefficients;
* DAC conditioning other than the defaults, and one scan per component;
* Pillow's own progressive files (with ``optimize``, restart markers and
  each subsampling).
"""

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
from tests import torch_jpeg_writer as jw

LAYOUTS = {"444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
           "420": [(2, 2), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
           "411": [(4, 1), (1, 1), (1, 1)], "3x1": [(3, 1), (1, 1), (1, 1)],
           "1x4": [(1, 4), (1, 1), (1, 1)], "chroma-above": [(1, 1), (2, 2), (2, 2)],
           "mixed": [(2, 2), (1, 2), (2, 1)]}
SIZES = ((37, 50), (17, 3), (5, 2), (1, 1))
KINDS = {"huffman-sequential": ("huffman", None), "arith-sequential": ("arith", None),
         "huffman-progressive": ("huffman", jw.PROGRESSIVE_SCRIPT),
         "arith-progressive": ("arith", jw.PROGRESSIVE_SCRIPT)}


def assert_equal_imageio(path):
    want, got = imageio.imread(path), read_jpeg(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), path.name


@pytest.mark.parametrize("restart", [0, 2], ids=["no-restart", "restart-2"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_kind_and_layout_equal_imageio(tmp_path, kind, layout, restart):
    coding, script = KINDS[kind]
    for k, (H, W) in enumerate(SIZES):
        img = jw.synth_image(H, W, 3, seed=k + len(layout))
        comps = jw.dct_components([img[..., i] for i in range(3)], LAYOUTS[layout], quality=85)
        p = tmp_path / f"{k}.jpg"
        jw.write_jpeg(p, comps, W, H, coding=coding, script=script, restart=restart)
        assert_equal_imageio(p)
        if coding == "arith":                 # the writer, held against Pillow
            jw.write_jpeg(tmp_path / "h.jpg", comps, W, H, script=script, restart=restart)
            assert np.array_equal(imageio.imread(p), imageio.imread(tmp_path / "h.jpg"))


DAC = [({0: (0, 1), 1: (2, 5), 2: (1, 1)}, {0: 5, 1: 1, 2: 63}),
       ({0: (3, 7), 1: (0, 0), 2: (0, 4)}, {0: 0, 1: 20, 2: 10})]


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("dac", range(len(DAC)))
def test_dac_conditioning_equals_imageio(tmp_path, dac, progressive):
    """Arithmetic DC bounds L, U and AC split Kx away from the defaults (0,
    1, 5), one table per component, with restarts."""
    img = jw.synth_image(29, 43, 3, seed=dac)
    comps = jw.dct_components([img[..., i] for i in range(3)], LAYOUTS["420"], quality=85)
    script = jw.PROGRESSIVE_SCRIPT if progressive else None
    p = tmp_path / "dac.jpg"
    jw.write_jpeg(p, comps, 43, 29, coding="arith", dac=DAC[dac], script=script, restart=5)
    assert_equal_imageio(p)
    jw.write_jpeg(tmp_path / "h.jpg", comps, 43, 29, script=script, restart=5)
    assert np.array_equal(imageio.imread(p), imageio.imread(tmp_path / "h.jpg"))


@pytest.mark.parametrize("coding", ["huffman", "arith"])
def test_one_scan_per_component_equals_imageio(tmp_path, coding):
    """Sequential files with a scan per component, each over its own block
    grid; luma 4x4 (17 blocks, more than an interleaved MCU may hold)."""
    img = jw.synth_image(29, 43, 3, seed=7)
    for layout in ([(4, 4), (1, 1), (1, 1)], LAYOUTS["mixed"]):
        comps = jw.dct_components([img[..., i] for i in range(3)], layout, quality=85)
        p = tmp_path / "sep.jpg"
        jw.write_jpeg(p, comps, 43, 29, coding=coding, interleave=False, restart=3)
        assert_equal_imageio(p)


PILLOW = [{"progressive": True}, {"progressive": True, "optimize": True},
          {"progressive": True, "optimize": True, "restart_marker_blocks": 3},
          {"progressive": True, "subsampling": 1, "restart_marker_rows": 1},
          {"progressive": True, "subsampling": 0}]


@pytest.mark.parametrize("kw", PILLOW, ids=["plain", "optimize", "optimize-rst-blocks",
                                            "422-rst-rows", "444"])
def test_pillow_progressive_equals_imageio(tmp_path, kw):
    for k, shape in enumerate(((37, 50), (16, 16), (9, 3), (2, 17), (1, 1))):
        p = tmp_path / f"{k}.jpg"
        Image.fromarray(jw.synth_image(*shape, 3, seed=k)).save(p, quality=90, **kw)
        assert_equal_imageio(p)


def _with_comment(data: bytes, n: int, scan: int) -> bytes:
    """``data`` with an n-byte COM segment before its scan-th SOS."""
    at = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"][scan]
    return data[:at] + b"\xff\xfe" + (n + 2).to_bytes(2, "big") + b"c" * n + data[at:]


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_arithmetic_scans_and_pillows_64k_pieces(tmp_path, progressive):
    """Pillow feeds libjpeg-turbo 64 KiB at a time and its arithmetic
    decoder cannot wait for more: imageio reads an arithmetic-coded scan
    only if every byte it needs, through the marker that ends it, lies in
    the piece where it starts. Shifted across byte 65536 one byte at a
    time by a comment before a scan, each file is read by both or refused
    by both; a progressive file past 64 KiB whose scans each fit a piece
    is read by both."""
    img = jw.synth_image(120, 160, 3, seed=4, noise=10.0)
    comps = jw.dct_components([img[..., i] for i in range(3)], LAYOUTS["444"], quality=95)
    script = jw.PROGRESSIVE_SCRIPT if progressive else None
    base = tmp_path / "base.jpg"
    jw.write_jpeg(base, comps, 160, 120, coding="arith", script=script, restart=7)
    data = base.read_bytes()
    scan = len(script) - 1 if progressive else 0
    outcomes = set()
    for shift in range(65536 - len(data) - 7, 65536 - len(data) - 2):
        p = tmp_path / f"s{shift}.jpg"
        p.write_bytes(_with_comment(data, shift, scan))
        try:
            want = imageio.imread(p)
        except OSError:
            with pytest.raises(ValueError, match=f"s{shift}.jpg: .*piece Pillow.*refuses"):
                read_jpeg(p)
            outcomes.add("refused")
            continue
        assert np.array_equal(read_jpeg(p), want)
        outcomes.add("read")
    assert outcomes == {"read", "refused"}
    if progressive:                       # the last scan alone in the second piece
        p = tmp_path / "fits.jpg"
        p.write_bytes(_with_comment(data, 65536 - data.rindex(b"\xff\xda"), scan))
        assert len(p.read_bytes()) > 65536
        assert_equal_imageio(p)


def _without_dht(path):
    data, out, pos = path.read_bytes(), b"\xff\xd8", 2
    while data[pos + 1] != 0xDA:                      # every segment before the scans
        n = 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out += b"" if data[pos + 1] == 0xC4 else data[pos:pos + n]
        pos += n
    path.write_bytes(out + data[pos:])


def test_files_without_huffman_tables(tmp_path):
    """Motion JPEG frames leave out the DHT segments of T.81's standard
    tables: libjpeg-turbo falls back to them in sequential scans
    (``std_huff_tables``) and refuses progressive and lossless scans
    without tables; so does the port."""
    img = jw.synth_image(29, 43, 3, seed=2)
    for k, kw in enumerate(({}, {"subsampling": 0})):
        p = tmp_path / f"{k}.jpg"
        Image.fromarray(img).save(p, quality=80, **kw)
        _without_dht(p)
        assert_equal_imageio(p)
    Image.fromarray(img).save(tmp_path / "p.jpg", quality=80, progressive=True)
    jw.write_jpeg(tmp_path / "l.jpg", jw.lossless_components([img[..., 0]], [(1, 1)], 1, 0),
                  43, 29, lossless=(1, 0))
    for name in ("p.jpg", "l.jpg"):
        _without_dht(tmp_path / name)
        with pytest.raises(OSError):
            imageio.imread(tmp_path / name)
        with pytest.raises(ValueError, match=f"{name}: scan names undefined Huffman table"):
            read_jpeg(tmp_path / name)
