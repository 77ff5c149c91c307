"""Reading the JAX package's checkpoints, without JAX.

Port of the reading half of ``nerf_sandbox_tpu/train/checkpoints.py``:
checkpoint discovery (``find_latest_checkpoint``, ``peek_checkpoint_meta``)
and a loader that turns the model parameters (MLP and k-planes grid) of a
JAX ``.ckpt`` file — an
``.npz`` of path-keyed arrays such as ``params_c||['trunk']||[0]||['w']``
plus a JSON ``__meta__`` member (JAX checkpoints.py:34-42, 94-98) — into this
package's state dicts, so a JAX-trained run renders here. Saving is ROADMAP
queue 1, P6.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_sandbox_tpu_torch.models.mlp import params_from_jax

_SEP = "||"
_STEP_RE = re.compile(r"(?:ckpt|step)[_-]?(\d+)", re.IGNORECASE)
_KEY_RE = re.compile(r"^\['(.*)'\]$|^\[(\d+)\]$")


def step_of_path(p) -> int:
    """Step number encoded in a checkpoint filename, or -1."""
    m = _STEP_RE.search(Path(p).name)
    return int(m.group(1)) if m else -1


def find_latest_checkpoint(ckpt_dir, out_dir=None) -> Optional[Path]:
    """Highest-step ``*.ckpt`` (tagged signal saves included, the
    ``ckpt_latest`` symlink excluded) in ``ckpt_dir`` and ``out_dir``."""
    candidates = []
    for d in filter(None, [ckpt_dir, out_dir]):
        d = Path(d)
        if d.is_dir():
            candidates += [p for p in d.glob("*.ckpt")
                           if not p.is_symlink() and _STEP_RE.search(p.name)]
    if not candidates:
        return None
    candidates.sort(key=lambda p: (step_of_path(p), p.stat().st_mtime))
    return candidates[-1]


def peek_checkpoint_meta(out_dir) -> Optional[tuple]:
    """Latest checkpoint's ``(step, saved-cfg dict)`` for a run directory,
    from the npz ``__meta__`` member or the orbax ``cfg_<step>.json`` echo,
    whichever is newer; None when the run has no checkpoint."""
    out_dir = Path(out_dir)
    best = None
    npz = find_latest_checkpoint(out_dir / "checkpoints", out_dir)
    if npz is not None:
        try:
            with np.load(npz, allow_pickle=False) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
            best = (int(meta.get("step", step_of_path(npz))),
                    dict(meta.get("cfg", {})))
        except (OSError, KeyError, ValueError) as e:
            print(f"[CKPT] could not read meta from {npz}: {e}")

    metas = sorted((out_dir / "checkpoints").glob("cfg_*.json"),
                   key=lambda p: int(p.stem.split("_")[-1]))
    if metas:
        try:
            meta = json.loads(metas[-1].read_text())
            step = int(meta.get("step", -1))
            if best is None or step > best[0]:
                best = (step, dict(meta.get("cfg", {})))
        except (OSError, ValueError) as e:
            print(f"[CKPT] could not read {metas[-1]}: {e}")
    return best


def _parse_key(path: str) -> list:
    parts = []
    for part in path.split(_SEP):
        m = _KEY_RE.match(part)
        if m is None:
            raise ValueError(f"unrecognised checkpoint key part {part!r}")
        parts.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
    return parts


def _listify(node):
    """Dicts keyed 0..n-1 (list entries) → lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _tree_from_flat(flat: dict, prefix: str):
    tree = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + _SEP):
            continue
        parts = _parse_key(key[len(prefix) + len(_SEP):])
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return _listify(tree) if tree else None


def load_params_from_jax_ckpt(path):
    """A JAX ``.ckpt`` file → (state dict of the coarse model, of the fine
    model), a k-planes ``pos_grid`` included; either is None if the file
    holds no such model."""
    with np.load(Path(path), allow_pickle=False) as zf:
        flat = {k: zf[k] for k in zf.files
                if k.startswith(("params_c" + _SEP, "params_f" + _SEP))}
    trees = [_tree_from_flat(flat, p) for p in ("params_c", "params_f")]
    return tuple(None if t is None else params_from_jax(t) for t in trees)
