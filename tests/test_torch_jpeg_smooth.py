"""Block smoothing (``nerf_sandbox_tpu_torch/data/jpeg_smooth.py``) against
``imageio.v2.imread`` (libjpeg-turbo's default, which Pillow keeps), bit
for bit: progressive files whose scan scripts leave low-frequency AC bits
unsent, Huffman- and arithmetic-coded, gray, 3- and 4-component, at
layouts whose luma has 2 block rows to an iMCU row (where the library's
row pointers read the padding blocks below the image) and at sizes 1-3
blocks wide (where the neighbourhood is clamped):

* DC only, with and without its low bit (the DC re-estimated, 9 ACs from
  the wide kernels);
* the first 2, the first 6 and all but the last of libjpeg's simple
  progression (ACs known to bit 1, or chroma never sent);
* AC 1-5 of luma sent whole, AC 1-9 to bit 1;
* a complete script, which is not smoothed.
"""

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_sandbox_tpu_torch.data import jpeg_smooth
from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg
from tests import torch_jpeg_writer as jw

S = jw.PROGRESSIVE_SCRIPT
SCRIPTS = {"dc-only": [((0, 1, 2), 0, 0, 0, 0)], "dc-al1": [((0, 1, 2), 0, 0, 0, 1)],
           "first-2": S[:2], "first-6": S[:6], "drop-last": S[:-1],
           "luma-1-5": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0), ((1,), 1, 63, 0, 0),
                        ((2,), 1, 63, 0, 0)],
           "luma-1-9-al1": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 9, 0, 1), ((1,), 1, 63, 0, 0),
                            ((2,), 1, 63, 0, 0)],
           "complete": S}
LAYOUTS = {"444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
           "440": [(1, 2), (1, 1), (1, 1)], "mixed": [(2, 1), (1, 2), (1, 1)]}
SIZES = ((40, 61), (45, 61), (72, 23), (8, 9), (16, 17), (24, 8))


@pytest.mark.parametrize("coding", ["huffman", "arith"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_smoothing_equals_imageio(tmp_path, script, layout, coding):
    for k, (H, W) in enumerate(SIZES):
        img = jw.synth_image(H, W, 3, seed=k)
        comps = jw.dct_components([img[..., i] for i in range(3)], LAYOUTS[layout], quality=80)
        p = tmp_path / f"{k}.jpg"
        jw.write_jpeg(p, comps, W, H, coding=coding, script=SCRIPTS[script])
        want, got = imageio.imread(p), read_jpeg(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (H, W)


def test_the_row_pointers_matter(tmp_path, monkeypatch):
    """Plain clamping of the block rows (no padding rows read) disagrees
    with libjpeg-turbo on a 4:2:0 file 40 rows high (luma 5 block rows in
    iMCU rows of 2); the library's pointer arithmetic agrees."""
    img = jw.synth_image(40, 61, 3, seed=1)
    comps = jw.dct_components([img[..., i] for i in range(3)], LAYOUTS["420"], quality=80)
    p = tmp_path / "q.jpg"
    jw.write_jpeg(p, comps, 61, 40, script=SCRIPTS["dc-only"])
    want = imageio.imread(p)
    assert np.array_equal(read_jpeg(p), want)
    monkeypatch.setattr(jpeg_smooth, "_pointer_rows", lambda hib, v, m: np.clip(
        np.arange(hib)[:, None] + np.arange(-2, 3)[None], 0, hib - 1))
    assert not np.array_equal(read_jpeg(p), want)


@pytest.mark.parametrize("coding", ["huffman", "arith"])
def test_gray_and_four_component_smoothing_equals_imageio(tmp_path, coding):
    """Gray frames whose one component has 2 or 3 block rows to an iMCU row,
    and CMYK / YCCK files with incomplete scripts."""
    gray = ([((0,), 0, 0, 0, 0)], [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 1)])
    four = [((0, 1, 2, 3), 0, 0, 0, 1), ((0,), 1, 5, 0, 0), ((3,), 1, 63, 0, 1)]
    k = 0
    for H, W in ((40, 61), (45, 30)):
        img = jw.synth_image(H, W, 4, seed=H)
        for layout in ([(2, 2)], [(1, 3)]):
            for script in gray:
                comps = jw.dct_components([img[..., 0]], layout, quality=75)
                jw.write_jpeg(tmp_path / f"{k}.jpg", comps, W, H, coding=coding, script=script)
                k += 1
        for layout, adobe in (([(1, 1)] * 4, 0), ([(2, 2), (1, 1), (1, 1), (1, 2)], 2)):
            comps = jw.dct_components([img[..., i] for i in range(4)], layout, quality=75)
            jw.write_jpeg(tmp_path / f"{k}.jpg", comps, W, H, coding=coding, script=four,
                          jfif=False, adobe=adobe)
            k += 1
    for i in range(k):
        want, got = imageio.imread(tmp_path / f"{i}.jpg"), read_jpeg(tmp_path / f"{i}.jpg")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), i
