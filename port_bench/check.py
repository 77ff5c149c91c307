"""The numbers the correctness check compares, and their limits.

Training (the first steps of a run, which go through the window's own call
and feed): each single step's loss against the reference's from the same
start (the program's parameters before that step), the losses of the two
chunks that follow (the capture, then a replay on fresh draws, as the
window's chunks are) against the reference's own path, the first gradient as the optimizer holds
it (Adam's first moment after one step, over ``1 - b1``) against the
reference's, leaf by leaf by the norm of their difference at the median
leaf, and the parameters' change over the single steps and over each chunk by the
gap of its norms at the worst leaf; each leaf's over the larger of the reference's norm of that
leaf and of the median leaf's. A leaf whose first gradient in the reference
is under a thousandth of the median leaf's moves by round-off alone under
Adam (a bias whose gradient cancels), and is left out of the change.

Rendering: every frame the window completed, on a sample of its pixels drawn
from the seed, against the reference's render of the same pose and pixels:
each frame's mean pixel gap (rgb, opacity, opacity-weighted depth) over the
gap that the configuration's own bf16 products give the reference, off the
last bin's kink, and the worst frame's. Random weights make frames from
nearly empty to dense, seed by seed, so an absolute gap has no scale that
holds across seeds; the reference's own bf16 gap is that scale, frame by
frame.
"""

from __future__ import annotations

import statistics

import torch

ROUNDOFF_LEAF = 1e-3
# rendered pixels whose last sample's density logit lies this close to 0
# are left out: the last bin's opacity flips there on rounding alone
KINK_BAND = 0.01


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_norms(tensors: dict) -> dict:
    """{name: float norm}, read from the device in one copy."""
    names = list(tensors)
    vals = torch.stack([tensors[n].detach().float().norm() for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def leaf_gap(prog: dict, ref: dict, keep=None, q: float = 1.0) -> tuple:
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖), over the
    leaves ``keep`` (all when None) → (the ``q`` quantile of them, 1 the
    worst; its leaf)."""
    names = [n for n in ref if keep is None or n in keep]
    if set(names) - set(prog):
        raise KeyError(f"the program lacks leaves {sorted(set(names) - set(prog))}")
    med = statistics.median(ref[n] for n in names)
    gaps = sorted((abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30), n) for n in names)
    return gaps[int(q * (len(gaps) - 1))]


def moving_leaves(grad_norms: dict) -> set:
    """The leaves whose first gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g >= ROUNDOFF_LEAF * med}


def grad_diff(prog: dict, ref: dict) -> float:
    """The first gradient, leaf by leaf: ‖prog - ref‖ / max(‖ref‖, median
    leaf ‖ref‖), at the median leaf; each side {leaf: tensor or array}."""
    norms = leaf_norms(ref)
    med = statistics.median(norms.values())
    gaps = leaf_norms({n: torch.as_tensor(prog[n], device=ref[n].device) - ref[n]
                       for n in ref})
    return statistics.median(gaps[n] / max(norms[n], med, 1e-30) for n in ref)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": the single steps', "chunk_losses":
    each chunk's mean and last, "grad1_vec": {leaf: the first gradient},
    "grad1": {leaf: its norm}, "moves": [{leaf: norm}, ...]};
    ``prog["own_losses"]``: the reference's loss of each single step from
    the program's own start of it → {number: value}: ``loss_gap`` the mean
    of the single steps' gaps to their own-start losses, ``chunk_loss_gap``
    the chunks' largest, ``grad_diff`` the first gradient's (:func:`grad_diff`),
    ``move_gap`` the change's norm at the worst leaf of the worst stage."""
    keep = moving_leaves(ref["grad1"])
    own = [rel_gap(p, r) for p, r in zip(prog["losses"], prog["own_losses"], strict=True)]
    chunk = max(rel_gap(p, r) for p, r in zip(prog["chunk_losses"], ref["chunk_losses"],
                                              strict=True))
    move = max(leaf_gap(p, r, keep)[0] for p, r in zip(prog["moves"], ref["moves"],
                                                       strict=True))
    return {"loss_gap": sum(own) / len(own), "chunk_loss_gap": chunk,
            "grad_diff": grad_diff(prog["grad1_vec"], ref["grad1_vec"]), "move_gap": move}


def train_diagnostics(prog: dict, ref: dict) -> dict:
    """Where each number comes from: every loss's gap, the first gradient's
    norm gap at its worst and 90th-percentile leaves, the change's worst
    leaves, the leaves left out of the change."""
    keep = moving_leaves(ref["grad1"])
    losses = prog["losses"] + prog["chunk_losses"]
    expect = ref["losses"] + ref["chunk_losses"]
    return {"loss_gaps": [rel_gap(p, r) for p, r in zip(losses, expect)],
            "own_loss_gaps": [rel_gap(p, r) for p, r in zip(prog["losses"],
                                                            prog["own_losses"])],
            "grad_norm_worst": leaf_gap(prog["grad1"], ref["grad1"]),
            "grad_norm_p90": leaf_gap(prog["grad1"], ref["grad1"], q=0.9),
            "move_leaves": [leaf_gap(p, r, keep)[1] for p, r in zip(prog["moves"],
                                                                    ref["moves"])],
            "left_out": sorted(set(ref["grad1"]) - keep)}


def pixel_gaps(got: dict, expect: dict, far: float) -> torch.Tensor:
    """Each sampled pixel's summed |gap| of rgb (3), opacity and opacity x
    depth / far; each side {rgb (S, 3), acc (S, 1), depth (S, 1)}."""
    def cols(o):
        return torch.cat([o["rgb"], o["acc"], o["acc"] * o["depth"] / far], -1)
    return torch.sum(torch.abs(cols(got) - cols(expect)), -1)


def frame_gap(got: dict, expect: dict, own: dict, far: float) -> float:
    """One frame's gap in units of the configuration's own rounding: the
    mean pixel gap of ``got`` to the fp32 reference ``expect`` over the mean
    pixel gap of ``own`` (the reference with the configuration's bf16
    products) to it, over the pixels off the last bin's kink (``expect``'s
    ``kink``, the smaller |density logit| of either pass's last sample, at
    least :data:`KINK_BAND`): there the infinite last bin's opacity flips
    on the logit's rounding alone."""
    off = expect["kink"] >= KINK_BAND
    num = pixel_gaps(got, expect, far)[off].mean()
    den = pixel_gaps(own, expect, far)[off].mean()
    return float(num / torch.clamp(den, min=1e-12))


def verdict(numbers: dict, limits: dict) -> tuple:
    """→ (correct, {number: {"value", "limit"}}) over the numbers the cell's
    limits name (a number with no upper reading is not compared). A number
    that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value == value and value <= limit
    return ok, out
