"""The readings that the correctness limits are set from, on the card.

    python3 -m port_bench.calibrate --workload <name> --seeds 1,2,3 [--sides ...] [--out FILE]

For each seed, at the cell's own sizes and through the same set-up and
checked path as a run (no measured window: training's readings need none;
a render reads as many frames as a run's window completes), one JSON line
with the numbers of:

* ``program``: the program against the reference (the lower reading is the
  largest over the seeds);
* ``control``: the reference computed with float8 products (a per-tensor
  scale), in the program's place (its smallest over the seeds is the upper
  reading);
* the faults planted in the reference put in the program's place
  (``--sides`` reads only those it names, besides ``program``):
  ``half_batch`` (training: the loss taken as the mean over the first half
  of each step's rays), ``unchanged`` (training: every step leaves the
  parameters as they were), ``no_exchange`` (training on several ranks:
  rank 0's step on its own share of the rays, weighted by its share, with
  the sum over the ranks left out) and ``stale_frame`` (rendering: each
  frame answered with the image of the pose after it).

One process serves every seed: the Trainer, its captured chunk and K2's
first launch are made once, and each seed's weights and optimizer state are
loaded into the same tensors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from port_bench import cells, check, harness, scene as scene_mod
from port_bench.reference import nerf as ref


def program_rank(cell, seeds: list, paths: tuple, device=None) -> list:
    """One rank's readings of the program's first steps for each seed, on
    the same captured chunk."""
    cell, dev, chunk, state, scene = harness.train_setup(cell, seeds[0], paths, device)
    st = ref.settings(cell["flags"])
    sp = harness.scene_params(cell)
    out = []
    for seed in seeds:
        harness.load_weights(state, ref.init_params(st, seed, dev))
        feed = harness.Feed(seed, st, sp["views"], sp["height"], sp["width"], dev)
        got = harness.first_steps(chunk, state._replace(host_step=0), scene, feed,
                                  int(cell["traffic"]["scan_steps"]))
        state = got.pop("state")
        out.append(got)
    del chunk, state, scene
    return out


def train_readings(cell: dict, seeds: list, dev, sides=None):
    st = ref.settings(cell["flags"])
    B = int(st["rays_per_batch"])
    world = int(cell["flags"].get("mesh_devices", 1) or 1)
    ranks = harness.on_ranks(cell, program_rank, (seeds, harness.cell_paths(cell)), dev)
    ref.strict_fp32()
    for i, seed in enumerate(seeds):
        expect = harness.reference_steps(cell, seed, dev)
        faults = {"control": dict(mode="fp8"), "half_batch": dict(rows=slice(0, B // 2)),
                  "unchanged": dict(frozen=True)}
        if world > 1:      # rank 0's own share, its sum over the ranks left out
            faults["no_exchange"] = dict(rows=slice(0, B // world), loss_scale=1.0 / world)
        raw = {"program": ranks[0][i]}
        raw.update({k: harness.reference_steps(cell, seed, dev, **kw)
                    for k, kw in faults.items() if sides is None or k in sides})
        for side in list(raw.values()) + [r[i] for r in ranks[1:]]:
            side["own_losses"] = harness.losses_at(cell, seed, dev, side.pop("states"))
        prog = [check.train_numbers(r[i], expect) for r in ranks]
        line = {"seed": seed,
                "program": {n: max(p[n] for p in prog) for n in prog[0]},
                "look": check.train_diagnostics(ranks[0][i], expect)}
        line.update({k: check.train_numbers(v, expect) for k, v in raw.items()
                     if k != "program"})
        for side in [expect, *raw.values()] + [r[i] for r in ranks[1:]]:
            side.pop("grad1_vec")
        expect.pop("states")
        line["raw"] = {"reference": expect, **raw}
        yield line


def render_readings(cell: dict, seeds: list, dev, frames_per_seed: int):
    sp = harness.scene_params(cell)
    tr = cell["traffic"]
    K = scene_mod.intrinsics(sp)
    poses = harness.path_poses(int(tr["path_frames"]), sp["radius"])
    st = ref.settings(cell["flags"])
    trainer = harness.make_trainer(cell, seeds[0], dev, harness.cell_paths(cell))
    model_c, model_f = trainer.eval_models()
    tile, chunk = trainer.render_tile, int(cell["flags"]["eval_chunk"])
    for seed in seeds:
        harness.load_weights(trainer.state, ref.init_params(st, seed, dev))
        rng = np.random.default_rng((int(seed) + harness.PIXEL_STREAM) % (1 << 63))
        frames = [harness.render_one(tile, model_c, model_f, poses, i, K, chunk, sp, dev,
                                     rng, int(tr["check_pixels"]))
                  for i in range(frames_per_seed)]
        ref.strict_fp32()
        expect = harness.reference_frames(cell, seed, frames, poses, K, dev)
        control = harness.reference_frames(cell, seed, frames, poses, K, dev, mode="fp8")
        own = harness.reference_frames(cell, seed, frames, poses, K, dev, mode="bf16")
        stale = harness.reference_frames(cell, seed, frames, poses, K, dev, shift=1)
        got = [fr[2] for fr in frames]
        sides = {"program": got, "control": control, "stale_frame": stale}
        yield {"seed": seed,
               **{k: {"frame_gap": harness.worst_frame_gap(cell, v, expect, own)}
                  for k, v in sides.items()},
               "raw": {k: [frame_stats(a, e, st) for a, e in zip(v, expect)]
                       for k, v in {**sides, "bf16_reference": own}.items()}}


def frame_stats(got: dict, expect: dict, st: dict) -> dict:
    """One frame's pixel gaps to the reference: their mean, quantiles and
    largest, and the pixels in the last bin's kink band."""
    d = check.pixel_gaps({n: v.to(expect["rgb"].device) for n, v in got.items()}, expect,
                         st["far"])
    q = torch.tensor([0.5, 0.9, 0.99], device=d.device)
    off = expect["kink"] >= check.KINK_BAND
    return {"mean": float(d.mean()), "quantiles": torch.quantile(d, q).tolist(),
            "max": float(d.max()), "mean_off_kink": float(d[off].mean()),
            "in_band": int((~off).sum())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--frames", type=int, default=20,
                   help="frames a seed renders (a run's window completes about this many)")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    p.add_argument("--sides", default=None,
                   help="comma-separated: the control and faults to read (default all)")
    args = p.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(scene_mod.CACHE / "triton"))
    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    sides = None if args.sides is None else set(args.sides.split(","))
    gen = (train_readings(cell, seeds, dev, sides) if cell["traffic"]["kind"] == "train"
           else render_readings(cell, seeds, dev, args.frames))
    lines = []
    for line in gen:
        lines.append(line)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    summary = {}
    for name in lines[0]["program"]:
        summary[name] = {"program_max": max(ln["program"][name] for ln in lines)}
        for fault in sorted(set(lines[0]) - {"seed", "program", "look", "raw"}):
            summary[name][f"{fault}_min"] = min(ln[fault][name] for ln in lines)
    print(json.dumps({"workload": args.workload, "seeds": len(lines), "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
