"""The benchmark's yardstick arithmetic: the card's peaks, and the operations
and bytes of the work a cell asks for, counted from the configuration's
shapes (never from what the program reports).

Counts are of the work the model needs, whatever implements it: the MLP's
multiply-accumulates per sample without the kernels' padding, the hash
scatter's bytes read once and written once.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s and HBM3
# bytes/s, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def mlp_macs_per_sample(cfg: dict) -> int:
    """Multiply-accumulates of one sample through the NeRF MLP: the trunk
    (the skip layer takes the encoding again), the feature, density and
    colour heads."""
    hashgrid = cfg.get("encoder") == "hashgrid"
    enc_pos = (int(cfg["hash_levels"]) * int(cfg["hash_features"]) if hashgrid
               else 3 + 6 * int(cfg["pos_num_freqs"]))
    enc_dir = 3 + 6 * int(cfg["dir_num_freqs"])
    H, layers, skip = int(cfg["hidden_dim"]), int(cfg["n_layers"]), int(cfg["skip_pos"])
    macs, in_dim = 0, enc_pos
    for i in range(layers):
        macs += (in_dim + (enc_pos if i == skip else 0)) * H
        in_dim = H
    return macs + H * H + H + (H + enc_dir) * (H // 2) + (H // 2) * 3


def samples_per_ray(cfg: dict) -> int:
    """Samples a ray takes through the models: ``nc`` coarse, then ``nc + nf``
    fine."""
    return 2 * int(cfg["nc"]) + int(cfg["nf"])


def train_samples_per_step(cfg: dict) -> int:
    """Ray-samples of one optimizer step over the whole (global) batch."""
    return int(cfg["rays_per_batch"]) * samples_per_ray(cfg)


def train_flops_per_step(cfg: dict) -> float:
    """MLP FLOPs of one optimizer step: forward and backward, 3 x 2 x MACs a
    sample."""
    return 6.0 * mlp_macs_per_sample(cfg) * train_samples_per_step(cfg)


def frame_flops(cfg: dict, height: int, width: int) -> float:
    """MLP FLOPs of one hierarchical frame: every pixel's ``nc`` coarse and
    ``nc + nf`` fine samples, 2 x MACs a sample."""
    return 2.0 * mlp_macs_per_sample(cfg) * height * width * samples_per_ray(cfg)


def k2_launch_flops(cfg: dict, tile_rays: int, samples: int) -> float:
    """The FLOP bound's numerator of one K2 launch: a tile of ``tile_rays``
    rays at ``samples`` samples a ray."""
    return 2.0 * mlp_macs_per_sample(cfg) * tile_rays * samples


def frame_k2_flops(cfg: dict, height: int, width: int, tile_rays: int) -> float:
    """K2's FLOPs of one frame as it is launched: ``ceil(H W / tile)`` tiles,
    a coarse launch of ``nc`` and a fine one of ``nc + nf`` samples each."""
    tiles = math.ceil(height * width / tile_rays)
    nc, nf = int(cfg["nc"]), int(cfg["nf"])
    return tiles * (k2_launch_flops(cfg, tile_rays, nc)
                    + k2_launch_flops(cfg, tile_rays, nc + nf))


def hash_scatter_bytes(pairs: int, features: int, rows: int) -> float:
    """The byte bound's numerator of one table-gradient scatter: each pair's
    int32 key and ``features`` fp32 values read once, the (rows, features)
    fp32 table gradient written once."""
    return pairs * (4 + 4 * features) + rows * features * 4


def hash_scatters_per_step(cfg: dict) -> list:
    """[(pairs, features, rows)] of the table gradients one step needs: one
    per model pass (coarse: ``nc`` points a ray, fine: ``nc + nf``), each
    point L levels x 8 corners, each model's table gradient written once,
    however many launches an implementation splits a pass into."""
    L, F = int(cfg["hash_levels"]), int(cfg["hash_features"])
    rows = L * (1 << int(cfg["hash_log2_size"]))
    rays, nc, nf = int(cfg["rays_per_batch"]), int(cfg["nc"]), int(cfg["nf"])
    return [(rays * n * L * 8, F, rows) for n in (nc, nc + nf)]


def hash_scatter_bytes_per_step(cfg: dict) -> float:
    return sum(hash_scatter_bytes(*s) for s in hash_scatters_per_step(cfg))
