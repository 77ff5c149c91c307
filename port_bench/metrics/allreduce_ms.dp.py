"""The gradient sums' device time per optimizer step on rank 0's card: the
NCCL kernels captured in the chunk, in milliseconds."""


def read(run):
    steps = run["counts"].get("steps")
    nccl = run["trace"].device_seconds(lambda n: "nccl" in n.lower())
    if not steps or run["counts"].get("world", 1) <= 1 or nccl <= 0:
        return None
    return 1000.0 * nccl / steps
