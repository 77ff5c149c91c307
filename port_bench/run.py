"""The benchmark's command: one run of one cell on the card(s) of this machine.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints progress and the program's own output on standard error, then each
number the correctness check compared beside its limit as the last lines of
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checks``, the numbers compared with their limits.

Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell asks for, or when a module of JAX or of the JAX package has
been loaded by the time the window has closed, in this process or in a rank
it spawned.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CACHE = Path(__file__).resolve().parent / ".cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's compile caches live in the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))

    import torch

    from port_bench import cells, harness
    harness.mark("imports")
    cell = cells.find_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # no context is made here before the run: under several ranks each card
    # holds its rank's process alone
    dev = torch.device("cuda", 0)
    try:
        line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), dev)
    except harness.ForbiddenModules as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
