"""Lossless JPEG (``nerf_sandbox_tpu_torch/data/jpeg_lossless.py``) and the
kinds imageio refuses, against ``imageio.v2.imread``:

* 8-bit lossless files of ``tests/torch_jpeg_writer.py``, predictors 1-7,
  point transforms 0 and 2, gray, RGB (Adobe transform 0, or no marker),
  subsampled RGB and CMYK, with and without restart intervals: bit-equal;
  and the writer itself: an RGB file at point transform 0 decodes to its
  input through Pillow;
* each kind imageio refuses makes both raise, the port naming the file and
  saying that imageio refuses it too: 12- and 16-bit, 2 and 5 components,
  hierarchical (SOF5, SOF7, SOF13), arithmetic-coded lossless (SOF11), a
  DNL height, fractional sampling, an interleaved MCU of 17 blocks, a
  lossless restart interval that splits a row, lossless YCbCr and YCCK.
"""

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
from tests import torch_jpeg_writer as jw

H, W = 23, 37
LAYOUTS = {"gray": (1, [(1, 1)], None), "rgb": (3, [(1, 1)] * 3, 0),
           "rgb-no-marker": (3, [(1, 1)] * 3, None),
           "rgb-420": (3, [(2, 2), (1, 1), (1, 1)], 0),
           "rgb-mixed": (3, [(1, 2), (1, 1), (2, 1)], 0),
           "cmyk": (4, [(2, 1), (1, 1), (1, 1), (2, 1)], 0)}


@pytest.mark.parametrize("restart_rows", [0, 2], ids=["no-restart", "restart-2-rows"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_equals_imageio(tmp_path, psv, layout, restart_rows):
    n, factors, adobe = LAYOUTS[layout]
    img = jw.synth_image(H, W, 4, seed=psv)
    mcux = -(-W // max(h for h, _ in factors))
    for pt in (0, 2):
        comps = jw.lossless_components([img[..., i] for i in range(n)], factors, psv, pt,
                                       restart_rows=restart_rows)
        p = tmp_path / f"{pt}.jpg"
        jw.write_jpeg(p, comps, W, H, lossless=(psv, pt), restart=restart_rows * mcux,
                      jfif=False, adobe=adobe)
        want, got = imageio.imread(p), read_jpeg(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), pt


def test_the_lossless_writer_is_lossless(tmp_path):
    img = jw.synth_image(H, W, 3, seed=1)
    comps = jw.lossless_components([img[..., i] for i in range(3)], [(1, 1)] * 3, 7, 0)
    jw.write_jpeg(tmp_path / "x.jpg", comps, W, H, lossless=(7, 0), jfif=False, adobe=0)
    assert np.array_equal(imageio.imread(tmp_path / "x.jpg"), img)


def _refused(tmp_path, kind):
    img = jw.synth_image(H, W, 5, seed=3)
    planes = [img[..., i] for i in range(5)]
    p = tmp_path / f"{kind}.jpg"
    dct = lambda n, layout=None: jw.dct_components(planes[:n], layout or [(1, 1)] * n)
    if kind == "12-bit":
        jw.write_jpeg(p, dct(3), W, H, precision=12)
    elif kind == "16-bit-lossless":
        jw.write_jpeg(p, jw.lossless_components(planes[:1], [(1, 1)], 1, 0), W, H,
                      lossless=(1, 0), precision=16)
    elif kind in ("2-components", "5-components"):
        jw.write_jpeg(p, dct(int(kind[0])), W, H)
    elif kind in ("sof5", "sof7", "sof13"):
        jw.write_jpeg(p, dct(3), W, H, sof={"sof5": 0xC5, "sof7": 0xC7, "sof13": 0xCD}[kind],
                      coding="arith" if kind == "sof13" else "huffman")
    elif kind == "sof11":
        jw.write_jpeg(p, jw.lossless_components(planes[:3], [(1, 1)] * 3, 1, 0), W, H,
                      lossless=(1, 0), sof=0xCB, jfif=False)
    elif kind == "dnl":
        jw.write_jpeg(p, dct(3), W, H, dnl=True)
    elif kind == "fractional":
        jw.write_jpeg(p, dct(3, [(3, 1), (1, 1), (1, 1)]), W, H)
        jw.set_sampling(p, [(3, 1), (2, 1), (1, 1)])
    elif kind == "mcu-17-blocks":
        jw.write_jpeg(p, dct(3, [(4, 4), (1, 1), (1, 1)]), W, H)
    elif kind == "lossless-restart-mid-row":
        jw.write_jpeg(p, jw.lossless_components(planes[:1], [(1, 1)], 1, 0), W, H,
                      lossless=(1, 0), restart=5)
    elif kind in ("lossless-ycbcr", "lossless-ycck"):
        n = 3 if kind == "lossless-ycbcr" else 4
        jw.write_jpeg(p, jw.lossless_components(planes[:n], [(1, 1)] * n, 1, 0), W, H,
                      lossless=(1, 0), jfif=n == 3, adobe=None if n == 3 else 2)
    return p


REFUSED = ["12-bit", "16-bit-lossless", "2-components", "5-components", "sof5", "sof7",
           "sof13", "sof11", "dnl", "fractional", "mcu-17-blocks", "lossless-restart-mid-row",
           "lossless-ycbcr", "lossless-ycck"]


@pytest.mark.parametrize("kind", REFUSED)
def test_refused_kinds_raise_on_both_sides(tmp_path, kind):
    p = _refused(tmp_path, kind)
    with pytest.raises(Exception):
        imageio.imread(p)
    with pytest.raises(ValueError, match=f"{kind}.jpg: .*imageio.v2.imread .*refuses it too"):
        read_jpeg(p)
