"""The table-gradient scatter's share of its roofline: the byte bound of the
traced steps' scatters (each pair's key and features read once, each
model's table gradient written once, at the HBM peak) over the device time
of the kernels named ``hash_scatter_*``."""


def read(run):
    steps = run["counts"].get("steps")
    hs = run["trace"].device_seconds(lambda n: "hash_scatter_" in n)
    if not steps or hs <= 0:
        return None
    ar = run["arith"]
    bound = steps * ar.hash_scatter_bytes_per_step(run["settings"]) / run["counts"]["world"]
    return 100.0 * bound / ar.PEAK_HBM_BYTES / hs
