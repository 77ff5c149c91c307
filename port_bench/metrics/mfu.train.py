"""The train step's MLP FLOPs over the traced window's time, as a share of
the card's bf16 peak, per card: 3 x 2 x the MLP's unpadded multiply-adds of
every ray-sample of every optimizer step the window completed."""


def read(run):
    steps = run["counts"].get("steps")
    if not steps:
        return None
    ar = run["arith"]
    flops = steps * ar.train_flops_per_step(run["settings"])
    return 100.0 * flops / (run["window_s"] * ar.PEAK_BF16_FLOPS * run["counts"]["world"])
