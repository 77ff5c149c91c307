"""K1: the whole NeRF MLP fused into one CUDA kernel (``csrc/fused_mlp.cu``).

Replaces the TPU kernel ``nerf_sandbox_tpu/ops/fused_mlp.py:fused_nerf_apply``
(Pallas body ``_kernel``). Bound on the H100: 1.19 MFLOP of bf16 tensor-core
work per row at the vanilla widths against ~190 bytes of HBM traffic, so
the tensor cores set the bound. The kernel runs ``wgmma`` on two warpgroups
of 64 rows that share each weight stage, so the ~1.2 MB of weights come from
L2 once per ``TILE_M`` = 128 rows; a producer warp streams them into shared
memory as one bulk copy per stage, from the buffer :func:`stage_weights`
lays out (design notes in ``csrc/mlp_tile.cuh``). Hidden activations stay
in registers between layers at hidden widths 128 and 256; at 384 and 512
(the wide path) they sit in shared memory; at every wider multiple of 128
(the large route, one instantiation for all) they sit in a ping-pong pair
of global buffers per warpgroup, the scratch :func:`large_scratch`
allocates per call, and bulk copies bring a layer's input into shared
memory a 64-column slice at a time. Both run each layer in output chunks
of up to 256 columns (:func:`large_chunks`). The kernels take every
width JAX's ``fusable`` takes.

Rounding points are those of the TPU kernel: bf16 operands, fp32
accumulation, fp32 add of the bf16-rounded bias, relu then a bf16 cast
between layers, skip as ``h@W_h + enc@W_e``, sigma from the last trunk
activation, the feature cast to bf16 before the colour head.

:func:`fused_nerf_apply_plain` is the same function in plain PyTorch (bf16
values upcast to fp32, fp32 products with TF32 off). :func:`fused_nerf_apply`
takes it only for CPU tensors; for CUDA tensors it launches the kernel or
raises, and counts the launch in ``fused_nerf_apply.launches`` (launches on
the large route also in ``fused_nerf_apply.large_launches``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.mlp import NeRFConfig, NeRFMLP
from nerf_sandbox_tpu_torch.ops import cuda_build

TILE_M = 128                 # rows per weight fetch (csrc/mlp_tile.cuh)
KC = 64                      # K rows of one weight stage (csrc/mlp_tile.cuh)
NCW = 128                    # output columns of a wide stage (csrc/mlp_tile.cuh)
LNC = 256                    # widest output chunk of the large route (csrc/mlp_tile.cuh)
N_CONSUMERS = 2              # consumer warpgroups of a block (csrc/mlp_tile.cuh)
WG_ROWS = 64                 # rows of one consumer warpgroup (csrc/mlp_tile.cuh)
# hidden widths with a compile-time path; every other multiple of 128 takes
# the large route (activations in global scratch, csrc/mlp_tile.cuh)
KERNEL_HIDDEN = (128, 256, 384, 512)
PLAIN_ROWS = 1 << 18         # row chunk of the plain version (bounds memory)
_ALIGN = 64                  # packed arrays start on 128-byte boundaries

PACK_FIELDS = ("w0", "b0", "w_mid", "b_mid", "wskip_h", "wskip_e", "bskip",
               "w_feat", "b_feat", "w_sig", "b_sig", "wc1", "bc1", "wc2t",
               "bc2")


def _enc_pads(cfg: NeRFConfig) -> tuple[int, int]:
    """Encoder widths padded for the tensor-core tiles (vanilla: 63→64, 27→32)."""
    ep = ((cfg.enc_pos_dim + 63) // 64) * 64
    ed = ((cfg.enc_dir_dim + 31) // 32) * 32
    return ep, ed


def fusable(cfg: NeRFConfig) -> bool:
    """The kernel covers the reference architecture family: one skip at
    0<skip_pos<n_layers, hidden multiple of 128, and at least one non-skip
    mid layer (n_layers >= 3)."""
    return (cfg.hidden_dim % 128 == 0 and 0 < cfg.skip_pos < cfg.n_layers
            and cfg.n_layers >= 3 and not cfg.app_dim)


def _pack_shapes(cfg: NeRFConfig) -> dict:
    H = cfg.hidden_dim
    ep, ed = _enc_pads(cfg)
    n_mid = cfg.n_layers - 2
    return {"w0": (ep, H), "b0": (H,), "w_mid": (n_mid, H, H),
            "b_mid": (n_mid, H), "wskip_h": (H, H), "wskip_e": (ep, H),
            "bskip": (H,), "w_feat": (H, H), "b_feat": (H,), "w_sig": (H,),
            "b_sig": (1,), "wc1": (H + ed, H // 2), "bc1": (H // 2,),
            "wc2t": (3, H // 2), "bc2": (3,)}


class PackedMLP(NamedTuple):
    """The MLP's weights as one bf16 buffer (the kernels' argument) plus a
    named view of each array in it. Weights are (in, out), except the
    colour output ``wc2t`` (3, H/2). ``staged`` is the weight stream the
    kernels copy into shared memory (:func:`stage_weights`), derived from
    ``views``."""

    cfg: NeRFConfig
    flat: torch.Tensor
    offsets: tuple
    views: dict
    staged: torch.Tensor


def pack_nerf_params(model: NeRFMLP) -> PackedMLP:
    """Pack the module's weights into the kernels' bf16 layout: encoder rows
    zero-padded (63→64, 27→32), the skip layer split into its h and enc
    blocks, the non-skip mid layers stacked."""
    cfg = model.cfg
    if not fusable(cfg):
        raise ValueError(f"the fused kernels do not cover {cfg}")
    shapes = _pack_shapes(cfg)
    offsets, total = [], 0
    for name in PACK_FIELDS:
        offsets.append(total)
        n = 1
        for s in shapes[name]:
            n *= s
        total += -(-n // _ALIGN) * _ALIGN
    dev = model.feature.weight.device
    flat = torch.zeros(total, dtype=torch.bfloat16, device=dev)
    views = {}
    for name, off in zip(PACK_FIELDS, offsets):
        n = 1
        for s in shapes[name]:
            n *= s
        views[name] = flat[off:off + n].view(shapes[name])

    H, P, D = cfg.hidden_dim, cfg.enc_pos_dim, cfg.enc_dir_dim
    with torch.no_grad():
        trunk = model.mlp
        views["w0"][:P].copy_(trunk[0].weight.T)
        views["b0"].copy_(trunk[0].bias)
        mids = [i for i in range(1, cfg.n_layers) if i != cfg.skip_pos]
        for k, i in enumerate(mids):
            views["w_mid"][k].copy_(trunk[i].weight.T)
            views["b_mid"][k].copy_(trunk[i].bias)
        wskip = trunk[cfg.skip_pos].weight.T                   # (H+P, H)
        views["wskip_h"].copy_(wskip[:H])
        views["wskip_e"][:P].copy_(wskip[H:])
        views["bskip"].copy_(trunk[cfg.skip_pos].bias)
        views["w_feat"].copy_(model.feature.weight.T)
        views["b_feat"].copy_(model.feature.bias)
        views["w_sig"].copy_(model.sigma_out.weight[0])
        views["b_sig"].copy_(model.sigma_out.bias)
        wc1 = model.color_fc.weight.T                          # (H+D, H/2)
        views["wc1"][:H].copy_(wc1[:H])
        views["wc1"][H:H + D].copy_(wc1[H:])
        views["bc1"].copy_(model.color_fc.bias)
        views["wc2t"].copy_(model.color_out.weight)
        views["bc2"].copy_(model.color_out.bias)
    return PackedMLP(cfg, flat, tuple(offsets), views, stage_weights(cfg, views))


def _stream_layers(cfg: NeRFConfig, views: dict) -> list:
    """The (K, N) weight arrays of each matmul, in the order the kernels' MLP
    runs them: W0, then per layer [W_mid] or [W_skip_h, W_skip_e], then
    W_feat, then the colour head's [W_c1's feature rows, its enc_dir rows]."""
    H = cfg.hidden_dim
    layers, mid = [[views["w0"]]], 0
    for layer in range(1, cfg.n_layers):
        if layer == cfg.skip_pos:
            layers.append([views["wskip_h"], views["wskip_e"]])
        else:
            layers.append([views["w_mid"][mid]])
            mid += 1
    layers.append([views["w_feat"]])
    return layers + [[views["wc1"][:H], views["wc1"][H:]]]


def _swizzle_index(n: int, device) -> torch.Tensor:
    """16-byte unit u of row r of a 128-byte row sits at u ^ (r % 8) (the
    128-byte swizzle wgmma reads); the map is its own inverse."""
    u = torch.arange(8, device=device)
    r = torch.arange(n, device=device)
    return u[None, :] ^ (r[:, None] % 8)


def _swizzle_rows(t: torch.Tensor) -> torch.Tensor:
    """(C, N, 64) → the same with each row's 8 units swizzled."""
    C, N, _ = t.shape
    idx = _swizzle_index(N, t.device)[None, :, :, None].expand(C, N, 8, 8)
    return t.reshape(C, N, 8, 8).gather(2, idx).reshape(C, N, KC)


def _stage_array(w: torch.Tensor, cols: int = 0) -> torch.Tensor:
    """(K, N) → K zero-padded to a multiple of 64, cut into 64-row chunks,
    each cut into parts of ``cols`` columns (0, or a width of N or more:
    whole), each part transposed to its columns' rows of 64 K values
    (K-major) and swizzled; flat, in (chunk, part) order."""
    K, N = w.shape
    kp = -(-K // KC) * KC
    sw = N if not cols or cols > N else cols
    wp = torch.zeros((kp, N), dtype=torch.bfloat16, device=w.device)
    wp[:K] = w
    parts = wp.reshape(kp // KC, KC, N // sw, sw).permute(0, 2, 3, 1)
    return _swizzle_rows(parts.reshape(-1, sw, KC)).reshape(-1)


def large_chunks(n_out: int) -> list:
    """The output chunks of a matmul ``n_out`` columns wide on the wide path
    and the large route, in order: 256 columns while that many remain, then
    128, then 64 (``csrc/mlp_tile.cuh:large_chunk``; 384 → 256, 128, 192 →
    128, 64; 640 → 256, 256, 128, 320 → 256, 64)."""
    widths = []
    while n_out > 0:
        widths.append(LNC if n_out >= LNC else 128 if n_out >= 128 else 64)
        n_out -= widths[-1]
    return widths


def stage_weights(cfg: NeRFConfig, views: dict) -> torch.Tensor:
    """The weight stream of the CUDA kernels, in the order their stages use
    it, each stage one contiguous bulk copy in the layout wgmma reads
    (:func:`_stage_array`). Hidden width 128 / 256: each array of
    :func:`_stream_layers` whole, stages of 64 K rows x N. Wider: per matmul
    and per output chunk of :func:`large_chunks`, the chunk's columns of
    each of its arrays, per 64 K rows in stages of ``NCW`` columns (384 and
    512, the wide path: two per 64 K rows of a 256-column chunk) or of the
    chunk's width (the large route). → a flat bf16 tensor (stages back to
    back)."""
    layers = _stream_layers(cfg, views)
    if cfg.hidden_dim <= 256:
        return torch.cat([_stage_array(w) for layer in layers for w in layer])
    cols = 0 if is_large(cfg) else NCW
    parts = []
    for layer in layers:
        n = 0
        for nc in large_chunks(layer[0].shape[1]):
            parts += [_stage_array(w[:, n:n + nc], cols) for w in layer]
            n += nc
    return torch.cat(parts)


def check_kernel_shape(cfg: NeRFConfig) -> None:
    """Raise for an MLP the CUDA kernels do not take, exactly where JAX's
    ``fusable`` (``nerf_sandbox_tpu/ops/fused_mlp.py``) is False: a hidden
    width that is not a multiple of 128, a skip layer outside the trunk,
    fewer than three layers. Hidden widths 128 / 256 keep a layer's
    accumulator in registers, 384 / 512 their activations in shared memory,
    wider ones in global scratch (the large route)."""
    H, n, skip = cfg.hidden_dim, cfg.n_layers, cfg.skip_pos
    if H % 128 or not 0 < skip < n or n < 3:
        raise ValueError(
            f"the CUDA kernels take the MLPs JAX's fusable takes: hidden width "
            f"a multiple of 128 (got {H}), 0 < skip_pos < n_layers (got "
            f"skip_pos {skip}, n_layers {n}) and n_layers >= 3")


def is_large(cfg: NeRFConfig) -> bool:
    """True where the kernels take the large route (hidden width above 512)."""
    return cfg.hidden_dim > KERNEL_HIDDEN[-1]


def large_scratch(cfg: NeRFConfig, device) -> tuple[torch.Tensor, int]:
    """The large route's activation scratch for one launch: a ping-pong pair
    of 64 x H bf16 buffers for each consumer warpgroup of each persistent
    block, sized from the grid (one block per SM), not from the batch
    (~66 MiB at H = 1024 on 132 SMs). → (tensor, blocks it serves)."""
    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    n = blocks * N_CONSUMERS * 2 * WG_ROWS * cfg.hidden_dim
    return torch.empty(n, dtype=torch.bfloat16, device=device), blocks


def as_packed(model) -> PackedMLP:
    """A module's packed weights; an already packed set passes through (so a
    caller that launches many tiles packs once)."""
    return model if isinstance(model, PackedMLP) else pack_nerf_params(model)


def mlp_rows_plain(packed: PackedMLP, ep: torch.Tensor,
                   ed: torch.Tensor) -> torch.Tensor:
    """K1's arithmetic on bf16 rows already padded to (R, EP) and (R, ED)
    → (R, 4) fp32; used by the plain versions of K1 and K2."""
    v, cfg = packed.views, packed.cfg
    H = cfg.hidden_dim

    def f(t):
        return t.float()

    def relu_bf16(y):
        return torch.relu(y).to(torch.bfloat16)

    h = relu_bf16(f(ep) @ f(v["w0"]) + f(v["b0"]))
    mid = 0
    for layer in range(1, cfg.n_layers):
        if layer == cfg.skip_pos:
            y = f(h) @ f(v["wskip_h"]) + f(ep) @ f(v["wskip_e"]) + f(v["bskip"])
        else:
            y = f(h) @ f(v["w_mid"][mid]) + f(v["b_mid"][mid])
            mid += 1
        h = relu_bf16(y)
    feature = (f(h) @ f(v["w_feat"]) + f(v["b_feat"])).to(torch.bfloat16)
    sigma = f(h) @ f(v["w_sig"]) + f(v["b_sig"])
    ch = relu_bf16(f(feature) @ f(v["wc1"][:H]) + f(ed) @ f(v["wc1"][H:])
                   + f(v["bc1"]))
    rgb = f(ch) @ f(v["wc2t"]).T + f(v["bc2"])
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def pad_cols_bf16(x: torch.Tensor, cols: int) -> torch.Tensor:
    """(R, c) → (R, cols) bf16 with zero columns appended."""
    out = torch.zeros((x.shape[0], cols), dtype=torch.bfloat16, device=x.device)
    out[:, :x.shape[1]] = x
    return out


def fused_nerf_apply_plain(packed: PackedMLP, enc_pos: torch.Tensor,
                           enc_dir: torch.Tensor) -> torch.Tensor:
    """K1's plain PyTorch version, on any device: (Q, P), (Q, D) → (Q, 4)."""
    ep_pad, ed_pad = _enc_pads(packed.cfg)
    outs = []
    for i in range(0, enc_pos.shape[0], PLAIN_ROWS):
        ep = pad_cols_bf16(enc_pos[i:i + PLAIN_ROWS].to(torch.bfloat16), ep_pad)
        ed = pad_cols_bf16(enc_dir[i:i + PLAIN_ROWS].to(torch.bfloat16), ed_pad)
        outs.append(mlp_rows_plain(packed, ep, ed))
    if not outs:
        return torch.zeros((0, 4), dtype=torch.float32, device=enc_pos.device)
    return torch.cat(outs)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def offsets_arg(packed: PackedMLP):
    return (ctypes.c_longlong * len(packed.offsets))(*packed.offsets)



def _launch(packed: PackedMLP, enc_pos: torch.Tensor,
            enc_dir: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream (inputs on one CUDA device)."""
    cfg = packed.cfg
    Q = enc_pos.shape[0]
    if enc_pos.shape != (Q, cfg.enc_pos_dim) or enc_dir.shape != (Q, cfg.enc_dir_dim):
        raise ValueError(f"fused_nerf_apply: expected (Q,{cfg.enc_pos_dim}) and "
                         f"(Q,{cfg.enc_dir_dim}), got {tuple(enc_pos.shape)} "
                         f"and {tuple(enc_dir.shape)}")
    for t in (enc_pos, enc_dir, packed.flat, packed.staged):
        if t.device != enc_pos.device or t.device.type != "cuda":
            raise ValueError("fused_nerf_apply: all tensors must be on one "
                             "CUDA device")
    check_kernel_shape(cfg)
    ep = enc_pos.to(torch.bfloat16).contiguous()
    ed = enc_dir.to(torch.bfloat16).contiguous()
    out = torch.empty((Q, 4), dtype=torch.float32, device=ep.device)
    ep_pad, ed_pad = _enc_pads(cfg)
    lib = cuda_build.load("fused_mlp")
    large = is_large(cfg)
    fn = lib.nerf_fused_mlp_large if large else lib.nerf_fused_mlp
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 8
                   + ([ctypes.c_void_p, ctypes.c_int] if large else [])
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    extra = []
    if large:
        scratch, blocks = large_scratch(cfg, ep.device)
        extra = [_ptr(scratch), blocks]
    stream = torch.cuda.current_stream(ep.device).cuda_stream
    err = fn(_ptr(ep), _ptr(ed), _ptr(packed.flat), offsets_arg(packed),
             _ptr(packed.staged), Q, cfg.enc_pos_dim, cfg.enc_dir_dim,
             cfg.hidden_dim, ep_pad, ed_pad, cfg.n_layers, cfg.skip_pos,
             *extra, _ptr(out), ctypes.c_void_p(stream))
    cuda_build.check(lib, err, "fused_mlp kernel launch")
    fused_nerf_apply.launches += 1
    fused_nerf_apply.large_launches += int(large)
    return out


def fused_nerf_apply(model: NeRFMLP | PackedMLP, enc_pos: torch.Tensor,
                     enc_dir: torch.Tensor, *, device=None) -> torch.Tensor:
    """Drop-in fused replacement for the bf16 MLP forward: enc_pos (Q, P),
    enc_dir (Q, D) → (Q, 4) fp32 raw [r, g, b, sigma] logits.

    Runs on ``cuda`` (the K1 kernel) unless ``device="cpu"`` (the plain
    version); the model's parameters (or its :class:`PackedMLP`) must
    already be on that device.
    """
    dev = resolve_device(device)
    packed = as_packed(model)
    if packed.flat.device.type != dev.type:
        raise ValueError(f"model is on {packed.flat.device}, asked to run on {dev}")
    enc_pos, enc_dir = enc_pos.to(dev), enc_dir.to(dev)
    if dev.type == "cpu":
        return fused_nerf_apply_plain(packed, enc_pos, enc_dir)
    return _launch(packed, enc_pos, enc_dir)


fused_nerf_apply.launches = 0
fused_nerf_apply.large_launches = 0
