"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, into
``build/`` at the repository root (listed in ``.gitignore``); the library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt. :func:`build_all` starts one ``nvcc`` per source (per part of a
source that is built in parts, :data:`PARTS`), all at once, and
keeps each compiler report (``-Xptxas -v``: registers, spills, notes) beside
its library, so that :func:`build_log` reads it for a cached build too.

Fast math is deliberately off: ``--use_fast_math`` turns ``sinf``/``cosf``
into ``__sinf``/``__cosf``, which are wrong at the thousands of radians the
top encode band reaches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("fused_mlp", "fused_raymarch", "kplanes_encode", "precision_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Sources compiled in parts (-DNERF_PART=0..n-1), all at once, then linked
# into one library: K2's 30 instantiations in eighteen groups, per encoder
# and contraction two for hidden widths 128 / 256, two for 384 / 512 and one
# for the large route (csrc/fused_raymarch.cu), which would take minutes in
# one compiler.
PARTS = {"fused_raymarch": 18}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # .cu and shared .cuh headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _log_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".log")


def build_log(name: str) -> str:
    """The compiler report of the built library of ``csrc/<name>.cu``, or
    "" if it has not been built."""
    path = _log_path(name)
    return path.read_text() if path.exists() else ""


def build_all(names=SOURCES) -> dict:
    """Compile every named source not yet built, one ``nvcc`` each (one per
    part for :data:`PARTS`, then a link), all in parallel. → {name:
    {"seconds": wall seconds until its library was done, "ptxas": compiler
    report}}. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = str(CSRC / f"{name}.cu")
        if name in PARTS:
            objs = [out.with_suffix(f".{os.getpid()}.{p}.o") for p in range(PARTS[name])]
            cmds = [[nvcc, *compile_flags, f"-DNERF_PART={p}", "-o", str(o), src]
                    for p, o in enumerate(objs)]
        else:
            objs, cmds = [], [[nvcc, *NVCC_FLAGS, "-o", str(tmp), src]]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        jobs[name] = (procs, objs, tmp, out)
    report, failed = {}, []
    for name, (procs, objs, tmp, out) in jobs.items():
        logs, ok = [], True
        for proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            ok = ok and proc.returncode == 0
        if ok and objs:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            ok = link.returncode == 0
        for o in objs:
            o.unlink(missing_ok=True)
        log = "".join(logs)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if not ok:
            failed.append(f"--- {name} (nvcc failed) ---\n{log}")
            continue
        _log_path(name).write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            lib.nerf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nerf_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.nerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
