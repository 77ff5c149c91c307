"""K2's share of its roofline: the FLOP bound of the frames' work (every
pixel's coarse and fine samples through the MLP, bf16 peak; K2 is bound by
the tensor cores) over the device time of the kernels named
``fused_raymarch_kernel`` in the trace."""


def read(run):
    frames = run["counts"].get("frames")
    k2 = run["trace"].device_seconds(lambda n: "fused_raymarch_kernel" in n)
    if not frames or k2 <= 0:
        return None
    ar, sc = run["arith"], run["scene"]
    bound = frames * ar.frame_flops(run["settings"], sc["height"], sc["width"])
    return 100.0 * bound / ar.PEAK_BF16_FLOPS / k2
