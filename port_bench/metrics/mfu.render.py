"""The frames' MLP FLOPs over the traced window's time, as a share of the
card's bf16 peak: every pixel's coarse and fine samples, 2 x the MLP's
unpadded multiply-adds each."""


def read(run):
    frames = run["counts"].get("frames")
    if not frames:
        return None
    ar, sc = run["arith"], run["scene"]
    flops = frames * ar.frame_flops(run["settings"], sc["height"], sc["width"])
    return 100.0 * flops / (run["window_s"] * ar.PEAK_BF16_FLOPS)
