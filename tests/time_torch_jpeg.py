"""Time the port's JPEG decoder on full-size frames (fern's 4032x3024).

Writes, with ``tests/torch_jpeg_writer.py`` (numpy, so it runs on a host
without Pillow), one 4032x3024 4:2:0 image at quality 90 three ways from
the same coefficients: sequential Huffman (baseline's decoding path),
progressive Huffman (libjpeg's simple progression, as Pillow writes it) and
sequential arithmetic; each about 3.8 MB, as a 12-megapixel phone frame.
Then decodes each ``--repeat`` times with ``data/jpeg.py:read_jpeg`` and
prints the seconds per decode with the host's CPU model. Where imageio is
installed, each file is also decoded by ``imageio.v2.imread`` (timed) and
the arrays compared. imageio refuses an arithmetic-coded file this large
(Pillow feeds libjpeg-turbo 64 KiB at a time, and its arithmetic decoder
cannot wait for more), and so does ``read_jpeg``; the script says so and
times the decoding with that check lifted. Files already in ``--dir`` are
reused. Host-side numbers; no device is used.

    python tests/time_torch_jpeg.py [--dir DIR] [--repeat 1] [--size 4032x3024]
"""

from __future__ import annotations

import argparse
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the writer by its folder: a host may have another package named "tests"
sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parent)]

import torch_jpeg_writer as jw  # noqa: E402

from nerf_sandbox_tpu_torch.data import jpeg  # noqa: E402
from nerf_sandbox_tpu_torch.data.jpeg import read_jpeg  # noqa: E402

KINDS = {"sequential-huffman-420": ("huffman", None),
         "progressive-huffman-420": ("huffman", jw.PROGRESSIVE_SCRIPT),
         "sequential-arith-420": ("arith", None)}


def cpu_model() -> str:
    model = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return (f"{model or 'model not reported'} ({platform.machine()}, {os.cpu_count()} "
            f"CPUs)")


def write_files(d: Path, W: int, H: int) -> dict:
    paths = {k: d / f"{k}_{W}x{H}.jpg" for k in KINDS}
    if all(p.exists() for p in paths.values()):
        return paths
    t = time.perf_counter()
    img = jw.synth_image(H, W, 3, seed=0, noise=4.0)
    comps = jw.dct_components([img[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)],
                              quality=90)
    for kind, (coding, script) in KINDS.items():
        jw.write_jpeg(paths[kind], comps, W, H, coding=coding, script=script)
    print(f"wrote {len(paths)} files in {time.perf_counter() - t:.1f} s", flush=True)
    return paths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--size", default="4032x3024")
    args = ap.parse_args()
    W, H = map(int, args.size.split("x"))
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(args.dir or tmp)
        d.mkdir(parents=True, exist_ok=True)
        paths = write_files(d, W, H)
        print(f"host CPU: {cpu_model()}; Python {platform.python_version()}, numpy "
              f"{np.__version__}", flush=True)
        for kind, p in paths.items():
            line = f"{kind}: {p.stat().st_size / 1e6:.3f} MB"
            want = None
            if imageio is not None:
                t = time.perf_counter()
                try:
                    want = imageio.imread(p)
                    line += f"; imageio.v2.imread {time.perf_counter() - t:.3f} s"
                except OSError:
                    line += "; imageio.v2.imread refuses it"
            times = []
            try:
                t = time.perf_counter()
                got = read_jpeg(p)
                times.append(time.perf_counter() - t)
            except ValueError as e:
                line += f"; read_jpeg refuses it too ({str(e).split(': ', 1)[1][:60]}...)"
            # the decoding itself, past the imitation of Pillow's read size
            saved, jpeg.PILLOW_MAXBLOCK = jpeg.PILLOW_MAXBLOCK, 1 << 62
            try:
                while len(times) < args.repeat:
                    t = time.perf_counter()
                    got = read_jpeg(p)
                    times.append(time.perf_counter() - t)
            finally:
                jpeg.PILLOW_MAXBLOCK = saved
            line += f"; decoding {min(times):.3f} s (min of {len(times)})"
            if want is not None:
                line += f", equal to imageio's: {np.array_equal(want, got)}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
