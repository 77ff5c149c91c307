"""``chip_smoke.py``'s reading of the kernels' ``-Xptxas -v`` reports, on the
CPU: each kernel's registers and spills, the wgmma notes attributed to the
kernel they name, readable names for K1, K2 and K5's instantiations, and the
build check that fails on a spill anywhere and on serialized wgmmas in any
instantiation (hidden width 128 / 256, the wide path at 384 / 512, the large
route above 512). Also its byte counts (the large route's scratch, the wide
path's shared-memory reads) and the parts ``ops/cuda_build.py`` compiles K2
in, which must be the parts that ``csrc/fused_raymarch.cu`` defines."""

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
    assert cs.kernel_label(K1_256) == "K1 fused_mlp<H=256>"
    assert cs.kernel_label(K1_512) == "K1 fused_mlp<H=512>"
    assert cs.kernel_label(K2_KP_384) == "K2 fused_raymarch<kplanes, contract, H=384>"
    assert cs.kernel_label(K5_X3) == "K5 precision_dot<bf16x3>"
    assert cs.kernel_label(K1_LARGE) == "K1 fused_mlp<H>512, large route>"
    assert cs.kernel_label(K2_IPE_LARGE) == "K2 fused_raymarch<ipe, H>512, large route>"
    assert (cs.kernel_label("_Z21kplanes_encode_kernelILi4ELi8EEvPKfiN4nerf6KpArgsEiP13__nv_bfloat16")
            == "K3 kplanes_encode<planes 4, lines 8>")
    assert (cs.kernel_label("_Z21kplanes_encode_kernelILi0ELi0EEvPKfiN4nerf6KpArgsEiP13__nv_bfloat16")
            == "K3 kplanes_encode<planes any, lines any>")


def test_entries_take_registers_spills_and_named_notes():
    log = _log({K1_256: (168, 0, [ARRIVE]), K1_512: (168, 12, [SERIAL, ARRIVE])})
    rows = cs.ptxas_entries(log)
    assert rows[K1_256]["regs"] == 168 and rows[K1_256]["spill_stores"] == 0
    assert len(rows[K1_256]["notes"]) == 1
    assert rows[K1_512]["spill_stores"] == 12 and rows[K1_512]["spill_loads"] == 12
    assert sum("serialized" in n for n in rows[K1_512]["notes"]) == 1


@pytest.mark.parametrize("case", ["clean", "arrive_only", "wide_serialized",
                                  "narrow_serialized", "spill", "large_serialized",
                                  "large_spill", "k2_wide_serialized"])
def test_build_check(case, monkeypatch):
    """Only a clean report and register-operand arrive notes (C7519) pass;
    a serializing note fails at every width, the wide path's included."""
    entries = {"clean": {K1_256: (168, 0, []), K1_512: (168, 0, [])},
               "arrive_only": {K1_256: (168, 0, [ARRIVE]), K1_512: (168, 0, [ARRIVE])},
               "wide_serialized": {K1_256: (168, 0, []), K1_512: (168, 0, [SERIAL])},
               "narrow_serialized": {K1_256: (168, 0, [SERIAL]), K1_512: (168, 0, [])},
               "spill": {K1_256: (168, 0, []), K2_KP_384: (168, 4, [])},
               "large_serialized": {K1_256: (168, 0, []), K1_LARGE: (168, 0, [SERIAL])},
               "large_spill": {K1_LARGE: (168, 0, []), K2_IPE_LARGE: (168, 8, [])},
               "k2_wide_serialized": {K1_512: (168, 0, [ARRIVE]),
                                      K2_KP_384: (168, 0, [SERIAL])}}[case]
    fake = types.SimpleNamespace(SOURCES=("fused_mlp",),
                                 build_log=lambda src: _log(entries))
    printed = []
    monkeypatch.setattr(cs, "print", lambda *a, **k: printed.append(a), raising=False)
    if case not in ("clean", "arrive_only"):
        with pytest.raises(cs.PhaseError) as e:
            cs.build_notes(fake)
        if "serialized" in case:
            assert "serializes its wgmmas" in str(e.value)
            assert any("serialized" in str(a) for a in printed)
        return
    cs.build_notes(fake)
    assert len(printed) == len(entries)


@pytest.mark.parametrize("hidden,chunks_per_64_rows", [(640, 8 * 3 + 2),
                                                       (1024, 8 * 4 + 2),
                                                       (1152, 8 * 5 + 3)])
def test_scratch_bytes_count_each_chunks_read(hidden, chunks_per_64_rows):
    """The large route reads a warpgroup's 64 x H input once per output
    chunk: per 64 rows of an 8-layer MLP, 7 trunk layers and the feature
    layer of H / 256 chunks (rounded up) and the colour head's H / 2; at
    1024, 34 x 128 KiB = 4.25 MiB. 2^20 rows are 8192 passes of 128."""
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    cfg = NeRFConfig(63, 27, n_layers=8, hidden_dim=hidden, skip_pos=4)
    read, written = cs.scratch_bytes(cfg, 8192)
    assert read == 16384 * chunks_per_64_rows * 64 * hidden * 2
    assert written == 16384 * 9 * 64 * hidden * 2
    if hidden == 1024:
        assert read == 16384 * 4.25 * 2 ** 20


@pytest.mark.parametrize("hidden", [256, 1024])
def test_fetch_line_adds_the_large_routes_activation_reads(hidden, capsys):
    """fetch_line's rates: the staged weights once per pass; on the large
    route also the scratch reads, with the rate of both together."""
    import torch

    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    cfg = NeRFConfig(63, 27, n_layers=8, hidden_dim=hidden, skip_pos=4)
    packed = types.SimpleNamespace(cfg=cfg, staged=torch.empty(1_000_000))
    cs.fetch_line("t", 10.0, 2.5, 8192, packed, "card")
    line = capsys.readouterr().out
    assert "16.384 GB of weights from L2 in 10.000 ms = 1.638 TB/s" in line
    assert "25.0% of the 2.500 ms bound | card" in line
    if hidden == 256:
        assert "scratch" not in line
    else:
        read = 16384 * 34 * 64 * 1024 * 2
        assert f"{read / 1e9:.3f} GB of activations read from scratch" in line
        assert f"= {(16.384e9 + read) / 10.0 / 1e9:.3f} TB/s;" in line


@pytest.mark.parametrize("hidden,a_per_pass,b_per_pass", [
    # per pass of 2 warpgroups: A = 64 rows x K x 2 B x stages per 64 K
    # rows; B = K x N x 2 B. 8 layers, skip 4, EP = EDP = 64: K of the ten
    # matmuls 64, H x 3, H + 64, H x 3, H, H + 64; the head H / 2 wide
    (384, 2 * 128 * (64 * 3 + 8 * 384 * 3 + 64 * 3 + (384 + 64) * 2),
     2 * 2 * (64 * 384 + 8 * 384 * 384 + 64 * 384 + (384 + 64) * 192)),
    (512, 2 * 128 * (64 * 4 + 8 * 512 * 4 + 64 * 4 + (512 + 64) * 2),
     2 * 2 * (64 * 512 + 8 * 512 * 512 + 64 * 512 + (512 + 64) * 256))])
def test_wide_smem_bytes_count_each_stages_reads(hidden, a_per_pass, b_per_pass):
    """The wide path's wgmma reads from shared memory: each warpgroup's A
    once per stage (NCW = 128 columns of a chunk per 64 K rows: 384 = 256 +
    128 takes 3 stages per 64 K rows, its head 192 = 128 + 64 two; 512 four,
    its head two), every stage's B once per warpgroup."""
    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    cfg = NeRFConfig(63, 27, n_layers=8, hidden_dim=hidden, skip_pos=4)
    assert cs.wide_smem_bytes(cfg, 1) == (a_per_pass, b_per_pass)
    assert cs.wide_smem_bytes(cfg, 8192) == (8192 * a_per_pass, 8192 * b_per_pass)


@pytest.mark.parametrize("hidden", [256, 512])
def test_fetch_line_adds_the_wide_paths_shared_memory_reads(hidden, capsys):
    """fetch_line on the wide path adds the bytes its wgmmas read from
    shared memory and their rate, card-wide and per SM of the 132."""
    import torch

    from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig
    cfg = NeRFConfig(63, 27, n_layers=8, hidden_dim=hidden, skip_pos=4)
    packed = types.SimpleNamespace(cfg=cfg, staged=torch.empty(1_000_000))
    cs.fetch_line("t", 10.0, 2.5, 8192, packed, "card")
    line = capsys.readouterr().out
    assert "16.384 GB of weights from L2 in 10.000 ms = 1.638 TB/s" in line
    if hidden == 256:
        assert "shared memory" not in line
    else:
        a, b = cs.wide_smem_bytes(cfg, 8192)
        assert f"{(a + b) / 1e9:.3f} GB read from shared memory by wgmma" in line
        assert f"= {(a + b) / 10.0 / 1e9:.3f} TB/s, " in line
        assert f"{(a + b) / 10.0 / 1e6 / 132:.1f} GB/s per SM" in line


def test_k2_parts_match_the_source():
    src = (cuda_build.CSRC / "fused_raymarch.cu").read_text()
    parts = {int(p) for p in re.findall(r"NERF_PART == (\d+)", src)}
    assert parts == set(range(cuda_build.PARTS["fused_raymarch"]))
    assert cuda_build.build_log("no_such_library") == ""


def test_cli_phase_writes_a_dataset_the_loaders_read_back(tmp_path):
    """Phase 9 writes bench.py's frames as a Blender dataset with
    ``data/png.py``; the port's loader reads them back bit for bit (frames
    made small here: the card's run writes 800x800) and the intrinsics
    match the focal length."""
    import numpy as np

    from nerf_sandbox_tpu_torch.data.blender_loader import BlenderSceneLoader
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (24, 24, 4), np.uint8) for _ in range(4)]
    K = np.array([[33.3, 0, 12], [0, 33.3, 12], [0, 0, 1]], np.float32)
    c2ws = [np.eye(4, dtype=np.float32) for _ in range(4)]
    cs.write_blender_scene(str(tmp_path), images, K, c2ws,
                           {"train": [0, 1, 2], "val": [3], "test": [3]})
    for split, idx in (("train", [0, 1, 2]), ("val", [3]), ("test", [3])):
        scene = BlenderSceneLoader(tmp_path).load(split)
        assert [np.array_equal(f.image, images[i].astype(np.float32) / 255.0)
                for f, i in zip(scene.frames, idx)] == [True] * len(idx)
        np.testing.assert_allclose(scene.frames[0].K, K, rtol=1e-5)


@pytest.mark.parametrize("F,Fl,time_res,per_row", [(8, 16, 0, 576), (4, 16, 0, 384),
                                                   (8, 16, 8, 576 + 2 * 3 * 2 * 16),
                                                   (1, 12, 0, 2 * 3 * 4 * 2 + 144)])
def test_kplanes_table_bytes(F, Fl, time_res, per_row):
    """Texel bytes K3 reads per sample: per scale 3 planes x 4 texels of F
    bf16, 3 folds x 2 texels for a 4-D grid, 3 lines x 2 texels of Fl."""
    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    kcfg = KPlanesConfig((64, 128), F, 512, Fl, aabb_scale=2.0, hybrid_freqs=6,
                         time_res=time_res)
    assert cs.kplanes_table_bytes(kcfg) == per_row


def test_kernel_ms_of_sums_the_matching_cuda_kernels():
    """The profiler's device time of the kernels a name matches, in ms (the
    events' ranges are in µs); None when no CUDA event matches."""
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, t0, t1):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=t0, end=t1))

    events = [ev("void kplanes_encode_kernel<false>(...)", cuda, 10.0, 760.0),
              ev("void kplanes_encode_kernel<false>(...)", cuda, 800.0, 900.0),
              ev("kplanes_encode", cpu, 0.0, 5000.0),
              ev("fused_raymarch_kernel", cuda, 0.0, 100.0)]
    assert cs.kernel_ms_of(torch, events, "kplanes_encode") == pytest.approx(0.85)
    assert cs.kernel_ms_of(torch, events, "precision_dot") is None


@pytest.mark.parametrize("profiled", [None, False, 0.45])
def test_k3_times_reads_the_device_time(monkeypatch, capsys, profiled):
    """k3_times: the device time from the graph, the event time of one call
    (host included) and the table read rate at the device time; when asked,
    the profiler's kernel time, and a trace with no K3 kernel fails."""
    import torch

    from nerf_sandbox_tpu_torch.models.kplanes import KPlanesConfig
    timed = iter([0.5, 0.8])                         # graph, events
    monkeypatch.setattr(cs, "graph_ms", lambda torch, fn, n=100: next(timed))
    monkeypatch.setattr(cs, "cuda_ms", lambda torch, fn, reps=10: next(timed))
    monkeypatch.setattr(cs, "profiled_kernel_ms",
                        lambda torch, fn, match: profiled or None)
    ke = types.SimpleNamespace(fused_kplanes_encode=lambda g, p, e: None)
    grid = types.SimpleNamespace(cfg=KPlanesConfig((64, 128), 8, 512, 16))
    pts = torch.zeros((1000, 3))
    if profiled is False:
        with pytest.raises(cs.PhaseError, match="no K3 kernel"):
            cs.k3_times(torch, ke, grid, pts, 128, "K3", "card", profiled=True)
        return
    got = cs.k3_times(torch, ke, grid, pts, 128, "K3", "card",
                      profiled=profiled is not None)
    assert got == (0.5, 0.8)
    out = capsys.readouterr().out
    assert "device 0.5000 ms" in out and "one call 0.8000 ms" in out
    assert f"576 B a row, {576e3 / 1e9:.3f} GB = {576e3 / 0.5 / 1e9:.3f} TB/s" in out
    assert ("profiler kernel time 0.4500 ms" in out) == (profiled is not None)
    assert out.endswith("| card\n")


def test_compare_builds_kp_grids():
    """compare_builds' k-planes table sets: the 360 configuration at full
    width (71 columns), with 4-feature planes (63), and 4-D folded at one
    time (its time folds packed between the planes and the lines)."""
    import torch

    from nerf_sandbox_tpu_torch import compare_builds as cb
    from nerf_sandbox_tpu_torch.models.mlp import NeRFMLP
    from nerf_sandbox_tpu_torch.ops import kplanes_encode as ke
    grids = cb.kp_grids(torch, ke, NeRFMLP, "cpu")
    assert list(grids) == ["", "_f4", "_4d"]
    assert [kc.out_dim for kc, _ in grids.values()] == [71, 63, 71]
    _, g4 = grids["_4d"]
    assert g4.t == 0.37 and len(g4.offsets) == 3 * 2 * 2 + 3
    assert any("fold" in n for n in g4.views) and grids[""][1].t is None
    assert len(ke.kp_c_args(grids["_f4"][1])) == len(ke.KP_C_ARGTYPES)


@pytest.mark.parametrize("name", ["as built", "one texel", "no sin/cos",
                                  "bands one at a time", "no plane tasks",
                                  "no line tasks", "no device writes",
                                  "cp.async.bulk copies", "zeros ahead of the rows",
                                  "streaming stores", "256 threads a block",
                                  "8 blocks an SM", "8 blocks, registers freed",
                                  "8 blocks an SM at 4 features",
                                  "registers unbounded", "one instantiation for all",
                                  "trig stores without conflicts"])
def test_kplanes_encode_probe_finds_its_edits(name):
    """``probe_kplanes_encode`` edits copies of csrc/kplanes_encode.cu(h) once
    per variant: every text it replaces is there exactly once, and every
    variant but the unedited build changes a file."""
    from nerf_sandbox_tpu_torch import probe_kplanes_encode as probe
    from nerf_sandbox_tpu_torch.compare_builds import edited_sources
    assert name in probe.VARIANTS and len(probe.VARIANTS) == 17
    texts = edited_sources(cuda_build.CSRC, probe.VARIANTS[name])
    assert (texts == {}) == (name == "as built")
    for fname, text in texts.items():
        assert text != (cuda_build.CSRC / fname).read_text()


def test_edited_sources_takes_each_text_once(tmp_path):
    """compare_builds.edited_sources: each edit's text replaced where it
    stands once; a text found twice or not at all is refused."""
    from nerf_sandbox_tpu_torch.compare_builds import edited_sources
    (tmp_path / "a.cu").write_text("x = 1;\ny = 2;\ny = 2;\n")
    assert edited_sources(tmp_path, {"a.cu": [("x = 1;", "x = 3;")]}) == {
        "a.cu": "x = 3;\ny = 2;\ny = 2;\n"}
    assert edited_sources(tmp_path, {}) == {}
    for text in ("y = 2;", "z = 0;"):
        with pytest.raises(ValueError, match="not in a.cu once"):
            edited_sources(tmp_path, {"a.cu": [(text, "")]})


def test_in_turns_times_forward_then_back():
    """compare_builds.in_turns: the names in order, then in reverse."""
    from nerf_sandbox_tpu_torch.compare_builds import in_turns
    calls = []
    times = in_turns({"a": 0, "b": 0, "c": 0}, lambda n: calls.append(n) or len(calls))
    assert calls == ["a", "b", "c", "c", "b", "a"]
    assert times == {"a": [1, 6], "b": [2, 5], "c": [3, 4]}
