"""The share of the traced window that the kernels named ``hash_scatter_*``
ran on the card, in percent."""


def read(run):
    hs = run["trace"].device_seconds(lambda n: "hash_scatter_" in n)
    if hs <= 0:
        return None
    return 100.0 * hs / run["window_s"]
