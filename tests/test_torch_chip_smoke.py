"""``chip_smoke.py``'s reading of the kernels' ``-Xptxas -v`` reports, on the
CPU: each kernel's registers and spills, the wgmma notes attributed to the
kernel they name, readable names for K1, K2 and K5's instantiations, and the
build check that fails on a spill anywhere and on serialized wgmmas at hidden
width 128 or 256 and on the large route (above 512), not on the wide path. Also: the parts ``ops/cuda_build.py`` compiles K2 in
are the parts that ``csrc/fused_raymarch.cu`` defines."""

import re
import types

import pytest

import chip_smoke as cs
from nerf_sandbox_tpu_torch.ops import cuda_build

K1_256 = "_Z16fused_mlp_kernelILi256EEvPK13__nv_bfloat16S2_iiiN4nerf7MlpArgsEPf"
K1_512 = "_Z16fused_mlp_kernelILi512EEvPK13__nv_bfloat16S2_iiiN4nerf7MlpArgsEPf"
K2_KP_384 = "_Z21fused_raymarch_kernelILi1ELb1ELi384EEv9MarchArgsN4nerf7MlpArgsENS1_6KpArgsE"
K1_LARGE = "_Z16fused_mlp_kernelILi0EEvPK13__nv_bfloat16S2_iiiN4nerf7MlpArgsEPf"
K2_IPE_LARGE = "_Z21fused_raymarch_kernelILi2ELb0ELi0EEv9MarchArgsN4nerf7MlpArgsENS1_6KpArgsE"
K5_X3 = "_ZN51_GLOBAL__N__0_18_precision_probe_cu_0precision_dot_kernelILi2EEEvPKfS2_Pfiii"


def _log(entries):
    """A report in ptxas's format: {name: (regs, spill bytes, [notes])}."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, (regs, spill, notes) in entries.items():
        lines += [f"ptxas info    : ({code}) {text} in the function '{name}'"
                  for code, text in notes]
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    8 bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 16 barriers"]
    return "\n".join(lines)


SERIAL = ("C7520", "Potential Performance Loss: wgmma.mma_async instructions "
          "are serialized due to program dependence on compiler-inserted WG.AR")
ARRIVE = ("C7519", "warpgroup.arrive is injected in around line 12 by compiler "
          "to allow use of registers in GMMA")


def test_labels_name_the_instantiations():
    assert cs.kernel_label(K1_256) == ("K1 fused_mlp<H=256>", False)
    assert cs.kernel_label(K1_512) == ("K1 fused_mlp<H=512>", True)
    assert cs.kernel_label(K2_KP_384) == (
        "K2 fused_raymarch<kplanes, contract, H=384>", True)
    assert cs.kernel_label(K5_X3) == ("K5 precision_dot<bf16x3>", None)
    assert cs.kernel_label(K1_LARGE) == ("K1 fused_mlp<H>512, large route>", False)
    assert cs.kernel_label(K2_IPE_LARGE) == (
        "K2 fused_raymarch<ipe, H>512, large route>", False)


def test_entries_take_registers_spills_and_named_notes():
    log = _log({K1_256: (168, 0, [ARRIVE]), K1_512: (168, 12, [SERIAL, ARRIVE])})
    rows = cs.ptxas_entries(log)
    assert rows[K1_256]["regs"] == 168 and rows[K1_256]["spill_stores"] == 0
    assert len(rows[K1_256]["notes"]) == 1
    assert rows[K1_512]["spill_stores"] == 12 and rows[K1_512]["spill_loads"] == 12
    assert sum("serialized" in n for n in rows[K1_512]["notes"]) == 1


@pytest.mark.parametrize("case", ["clean", "arrive_only", "wide_serialized",
                                  "narrow_serialized", "spill", "large_serialized",
                                  "large_spill"])
def test_build_check(case, monkeypatch):
    entries = {"clean": {K1_256: (168, 0, []), K1_512: (168, 0, [])},
               "arrive_only": {K1_256: (168, 0, [ARRIVE]), K1_512: (168, 0, [ARRIVE])},
               "wide_serialized": {K1_256: (168, 0, []), K1_512: (168, 0, [SERIAL])},
               "narrow_serialized": {K1_256: (168, 0, [SERIAL]), K1_512: (168, 0, [])},
               "spill": {K1_256: (168, 0, []), K2_KP_384: (168, 4, [])},
               "large_serialized": {K1_256: (168, 0, []), K1_LARGE: (168, 0, [SERIAL])},
               "large_spill": {K1_LARGE: (168, 0, []), K2_IPE_LARGE: (168, 8, [])}}[case]
    fake = types.SimpleNamespace(SOURCES=("fused_mlp",),
                                 build_log=lambda src: _log(entries))
    monkeypatch.setattr(cs, "print", lambda *a, **k: None, raising=False)
    if case in ("narrow_serialized", "spill", "large_serialized", "large_spill"):
        with pytest.raises(cs.PhaseError):
            cs.build_notes(fake)
        return
    notes = cs.build_notes(fake)
    assert bool(notes) == (case == "wide_serialized")


def test_k2_parts_match_the_source():
    src = (cuda_build.CSRC / "fused_raymarch.cu").read_text()
    parts = {int(p) for p in re.findall(r"NERF_PART == (\d+)", src)}
    assert parts == set(range(cuda_build.PARTS["fused_raymarch"]))
    assert cuda_build.build_log("no_such_library") == ""
