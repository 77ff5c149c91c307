"""Colour of ``nerf_sandbox_tpu_torch/data/jpeg.py`` against
``imageio.v2.imread``, bit for bit:

* 4 components: CMYK (no Adobe marker, or transform 0) and YCCK (transform
  2, or an unknown one), sequential and progressive, Huffman- and
  arithmetic-coded, 4:4:4:4 and subsampled; Pillow's own CMYK files. All
  come back as uint8 (H, W, 4) with Pillow's inversion;
* gray files of every coding, with sampling factors other than 1x1;
* 3 components read as RGB or as YCbCr from the JFIF and Adobe markers
  and the component ids.
"""

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
from tests import torch_jpeg_writer as jw


def assert_equal_imageio(path):
    want, got = imageio.imread(path), read_jpeg(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want), path.name


SCAN4 = [((0, 1, 2, 3), 0, 0, 0, 0)] + [((i,), 1, 63, 0, 0) for i in range(4)]
CODINGS = {"huffman": ("huffman", None), "arith": ("arith", None),
           "huffman-progressive": ("huffman", SCAN4), "arith-progressive": ("arith", SCAN4)}


@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("adobe", [None, 0, 2, 1], ids=["cmyk-no-marker", "cmyk", "ycck",
                                                         "ycck-unknown-transform"])
def test_four_components_equal_imageio(tmp_path, adobe, coding):
    img = jw.synth_image(29, 43, 4, seed=2)
    for k, layout in enumerate(([(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)])):
        comps = jw.dct_components([img[..., i] for i in range(4)], layout, quality=85)
        p = tmp_path / f"{k}.jpg"
        jw.write_jpeg(p, comps, 43, 29, coding=CODINGS[coding][0], script=CODINGS[coding][1],
                      jfif=False, adobe=adobe)
        assert_equal_imageio(p)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_pillow_cmyk_equals_imageio(tmp_path, progressive):
    for k, shape in enumerate(((29, 43), (3, 5))):
        p = tmp_path / f"{k}.jpg"
        Image.fromarray(jw.synth_image(*shape, 3, seed=k)).convert("CMYK").save(
            p, quality=90, progressive=progressive)
        assert_equal_imageio(p)


@pytest.mark.parametrize("coding", list(CODINGS))
def test_gray_equals_imageio(tmp_path, coding):
    img = jw.synth_image(29, 43, 1, seed=5)[..., 0]
    script = CODINGS[coding][1] and [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 1), ((0,), 6, 63, 0, 0),
                                     ((0,), 0, 0, 1, 0), ((0,), 1, 5, 1, 0)]
    for k, layout in enumerate(([(1, 1)], [(2, 2)], [(1, 3)])):
        comps = jw.dct_components([img], layout, quality=70)
        p = tmp_path / f"{k}.jpg"
        jw.write_jpeg(p, comps, 43, 29, coding=CODINGS[coding][0], script=script, restart=3)
        assert_equal_imageio(p)


MARKERS = [(False, 0, None), (False, None, [82, 71, 66]), (True, 0, None), (False, 1, None),
           (False, None, [5, 6, 7]), (False, None, None)]


@pytest.mark.parametrize("jfif,adobe,ids", MARKERS, ids=[
    "adobe-0-rgb", "ids-rgb", "jfif-wins", "adobe-1", "unknown-ids", "no-markers"])
def test_three_component_colour_space_equals_imageio(tmp_path, jfif, adobe, ids):
    img = jw.synth_image(29, 43, 3, seed=9)
    comps = jw.dct_components([img[..., i] for i in range(3)], [(2, 1), (1, 1), (1, 1)],
                              quality=85, ids=ids)
    p = tmp_path / "m.jpg"
    jw.write_jpeg(p, comps, 43, 29, jfif=jfif, adobe=adobe, coding="arith")
    assert_equal_imageio(p)
