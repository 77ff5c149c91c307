"""LLFF scenes of JPEGs past baseline through the port's loader and the JAX
package's ``LLFFSceneLoader`` (which reads them with ``imageio.v2.imread``):

* progressive files (Pillow's, with ``optimize`` and restart markers, and
  the writer's arithmetic-coded and smoothed ones): equal images;
* CMYK files (Pillow's, and the writer's YCCK): equal 4-channel images, and
  the port's ``sample_ray_batch`` targets equal JAX's for the same draws
  (the 4th channel composited as alpha over white, bit for bit).
"""

import numpy as np
from PIL import Image

from nerf_sandbox_tpu.data import sampler as jsampler
from nerf_sandbox_tpu.data.llff_loader import LLFFSceneLoader as JLLFF
from nerf_sandbox_tpu_torch.data import sampler as tsampler
from nerf_sandbox_tpu_torch.data.llff_loader import LLFFSceneLoader
from tests import torch_jpeg_writer as jw
from tests.test_loaders import _make_llff
from tests.test_torch_sampler import _hold, _pair

H, W = 24, 32


def _jpeg_scene(root, write):
    """``_make_llff``'s poses with each PNG replaced by ``write(i, path)``."""
    root = _make_llff(root, n=4, H=H, W=W)
    for i, p in enumerate(sorted((root / "images").glob("*.png"))):
        write(i, p.with_suffix(".jpg"))
        p.unlink()
    return root


def _loaded_equal(root):
    port, ref = LLFFSceneLoader(root), JLLFF(root)
    scenes = {}
    for split in ("train", "test"):
        a, b = port.load(split), ref.load(split)
        assert len(a.frames) == len(b.frames)
        for fa, fb in zip(a.frames, b.frames):
            assert fa.image.dtype == fb.image.dtype and fa.image.shape == fb.image.shape
            assert np.array_equal(fa.image, fb.image)
        scenes[split] = (a, b)
    return scenes


def _write_progressive(i, path):
    img = jw.synth_image(H, W, 3, seed=i)
    if i < 2:
        Image.fromarray(img).save(path, quality=90, progressive=True, optimize=i == 1,
                                  restart_marker_blocks=3 * i)
    else:
        comps = jw.dct_components([img[..., k] for k in range(3)],
                                  [(2, 2), (1, 1), (1, 1)], quality=90)
        script = jw.PROGRESSIVE_SCRIPT if i == 2 else jw.PROGRESSIVE_SCRIPT[:-1]
        jw.write_jpeg(path, comps, W, H, coding="arith" if i == 2 else "huffman",
                      script=script)


def test_progressive_scene_loads_like_the_jax_loader(tmp_path):
    _loaded_equal(_jpeg_scene(tmp_path / "fern", _write_progressive))


def _write_cmyk(i, path):
    img = jw.synth_image(H, W, 4, seed=i)
    if i < 3:
        Image.fromarray(img[..., :3]).convert("CMYK").save(path, quality=90,
                                                           progressive=i == 1)
    else:
        comps = jw.dct_components([img[..., k] for k in range(4)], [(1, 1)] * 4, quality=90)
        jw.write_jpeg(path, comps, W, H, jfif=False, adobe=2)


def test_cmyk_scene_loads_and_samples_like_jax(tmp_path):
    scenes = _loaded_equal(_jpeg_scene(tmp_path / "fern", _write_cmyk))
    port, ref = scenes["train"]
    assert port.frames[0].image.shape == (H, W, 4)
    jarr = jsampler.SceneArrays.from_scene(ref)
    tarr = tsampler.SceneArrays.from_scene(port, device="cpu")
    for step in (1, 7):
        _, want, got = _pair(jarr, tarr, step, seed=step)
        _hold(want, got)
