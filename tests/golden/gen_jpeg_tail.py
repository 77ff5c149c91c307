"""Write the JPEG fixtures of ``chip_smoke.py`` phase 11c and their digests.

The eight 504x378 views of ``chip_smoke.write_llff_scene`` (fern's
``images_8`` size), one JPEG kind each, for a fern Quickstart on such
files; beside them small files (128x96 and less): CMYK (Adobe transform
0), YCCK (transform 2), lossless, and one file of each kind imageio
refuses. ``manifest.json`` holds, per decoded file, the sha256, shape and
dtype of ``imageio.v2.imread``'s array (Pillow and libjpeg-turbo), and the
names of the refused files; the card's host has neither Pillow nor
imageio. Needs Pillow and imageio:

    python tests/golden/gen_jpeg_tail.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
OUT = Path(__file__).resolve().parent / "jpeg_tail"
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from tests import torch_jpeg_writer as jw  # noqa: E402

S = jw.PROGRESSIVE_SCRIPT
C420, C440 = [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)]
C411, ABOVE = [(4, 1), (1, 1), (1, 1)], [(1, 1), (2, 2), (2, 2)]
# view i -> (file name, how it is written)
VIEWS = [("view0_pillow_progressive.jpg", {"pillow": {"progressive": True}}),
         ("view1_pillow_progressive_optimize_restarts.jpg",
          {"pillow": {"progressive": True, "optimize": True, "restart_marker_blocks": 4}}),
         ("view2_incomplete_script_smoothed.jpg", {"layout": C420, "script": S[:-1]}),
         ("view3_arith_sequential_420.jpg", {"layout": C420, "coding": "arith"}),
         ("view4_arith_progressive.jpg", {"layout": C420, "coding": "arith", "script": S,
                                          "restart": 12}),
         ("view5_440.jpg", {"layout": C440}),
         ("view6_411.jpg", {"layout": C411, "restart": 9}),
         ("view7_chroma_above_luma.jpg", {"layout": ABOVE})]


def write_view(path, img, how):
    from PIL import Image

    if "pillow" in how:
        Image.fromarray(img).save(path, quality=90, **how["pillow"])
        return
    comps = jw.dct_components([img[..., i] for i in range(3)], how["layout"], quality=90)
    jw.write_jpeg(path, comps, img.shape[1], img.shape[0], coding=how.get("coding", "huffman"),
                  script=how.get("script"), restart=how.get("restart", 0))


def write_small(out: Path, img: np.ndarray) -> dict:
    """The small files → {name: True if imageio should refuse it}."""
    H, W = img.shape[:2]
    cmyk = np.concatenate([img, img[..., :1] // 2], axis=-1)
    planes = [cmyk[..., i] for i in range(4)]
    comps = jw.dct_components(planes, [(1, 1)] * 4, quality=90)
    jw.write_jpeg(out / "cmyk_adobe0.jpg", comps, W, H, jfif=False, adobe=0)
    comps = jw.dct_components(planes, [(2, 2), (1, 1), (1, 1), (2, 2)], quality=90)
    jw.write_jpeg(out / "ycck_adobe2.jpg", comps, W, H, jfif=False, adobe=2, coding="arith")
    comps = jw.lossless_components(planes[:3], [(2, 1), (1, 1), (1, 1)], 4, 1, restart_rows=8)
    jw.write_jpeg(out / "lossless_rgb_422.jpg", comps, W, H, lossless=(4, 1),
                  restart=8 * (W // 2), jfif=False, adobe=0)
    small = {"cmyk_adobe0.jpg": False, "ycck_adobe2.jpg": False,
             "lossless_rgb_422.jpg": False}
    h, w = 32, 48                                     # the refused kinds, smaller
    five = [cmyk[:h, :w, i % 4] for i in range(5)]
    dct = lambda n, layout=None: jw.dct_components(five[:n], layout or [(1, 1)] * n)
    refused = {
        "refused_12bit.jpg": lambda p: jw.write_jpeg(p, dct(3), w, h, precision=12),
        "refused_16bit_lossless.jpg": lambda p: jw.write_jpeg(
            p, jw.lossless_components(five[:1], [(1, 1)], 1, 0), w, h, lossless=(1, 0),
            precision=16),
        "refused_2_components.jpg": lambda p: jw.write_jpeg(p, dct(2), w, h),
        "refused_5_components.jpg": lambda p: jw.write_jpeg(p, dct(5), w, h),
        "refused_hierarchical_sof5.jpg": lambda p: jw.write_jpeg(p, dct(3), w, h, sof=0xC5),
        "refused_arith_lossless_sof11.jpg": lambda p: jw.write_jpeg(
            p, jw.lossless_components(five[:3], [(1, 1)] * 3, 1, 0), w, h, lossless=(1, 0),
            sof=0xCB, jfif=False),
        "refused_dnl.jpg": lambda p: jw.write_jpeg(p, dct(3), w, h, dnl=True),
        "refused_fractional_sampling.jpg": lambda p: (
            jw.write_jpeg(p, dct(3, [(3, 1), (1, 1), (1, 1)]), w, h),
            jw.set_sampling(p, [(3, 1), (2, 1), (1, 1)]))}
    for name, write in refused.items():
        write(out / name)
        small[name] = True
    return small


def main() -> None:
    import imageio.v2 as imageio

    OUT.mkdir(exist_ok=True)
    for old in OUT.glob("*.jpg"):
        old.unlink()
    with tempfile.TemporaryDirectory() as d:
        images = chip_smoke.write_llff_scene(d)
    kinds = {}
    for (name, how), img in zip(VIEWS, images):
        write_view(OUT / name, img, how)
        kinds[name] = False
    kinds.update(write_small(OUT, images[0][:96, :128]))
    decoded, refused = {}, []
    for name, want_refused in kinds.items():
        try:
            arr = imageio.imread(OUT / name)
        except Exception:
            if not want_refused:
                raise
            refused.append(name)
            continue
        if want_refused:
            raise SystemExit(f"imageio reads {name}, which should be refused")
        decoded[name] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                         "shape": list(arr.shape), "dtype": str(arr.dtype)}
    manifest = {"views": [name for name, _ in VIEWS], "decoded": decoded, "refused": refused}
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(decoded)} decoded and {len(refused)} refused files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
