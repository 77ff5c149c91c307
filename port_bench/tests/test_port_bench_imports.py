"""Nothing the harness or the reference imports is JAX or the JAX package
(top-level names compared whole, so ``nerf_sandbox_tpu_torch`` is not
caught), and the reference imports nothing of the measured program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from port_bench.tests.bench_copy import REPO

PKG = REPO / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_sandbox_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = [p for p in PKG.rglob("*.py") if ".cache" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not top_level_imports(p) & FORBIDDEN, p


def test_the_reference_imports_torch_and_the_standard_library_only():
    for p in (PKG / "reference").rglob("*.py"):
        names = top_level_imports(p)
        assert names <= {"__future__", "math", "json", "torch"}, (p, names)


def test_a_run_loads_no_jax():
    """In a fresh interpreter, the harness, the reference and the program's
    modules a run uses load no module of JAX or of the JAX package."""
    code = ("import sys; import port_bench.harness, port_bench.calibrate, "
            "nerf_sandbox_tpu_torch.train.trainer, nerf_sandbox_tpu_torch.render.renderer, "
            "nerf_sandbox_tpu_torch.scripts.train_nerf\n"
            "bad = {m.split('.', 1)[0] for m in sys.modules} & "
            f"{FORBIDDEN!r}\n"
            "ref = 'nerf_sandbox_tpu_torch' in {m.split('.', 1)[0] for m in sys.modules}\n"
            "print(sorted(bad), ref)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.split("\n")[-2]
    assert out == "[] True"


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, port_bench.reference.nerf\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & "
            "{'nerf_sandbox_tpu_torch', 'nerf_sandbox_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
