"""The Fig.-7 NeRF MLP as an ``nn.Module``.

Port of ``nerf_sandbox_tpu/models/mlp.py`` (reference
``nerf_sandbox/source/models/mlps.py:35-314``):

* ``n_layers`` x ``hidden_dim`` ReLU trunk; the layer at ``skip_pos`` takes
  ``[h, gamma(x)]`` as its input.
* Heads ``feature`` (no activation), ``sigma_out`` (raw), ``color_fc``
  (on ``[feature, enc_dir]``, ReLU) and ``color_out`` (raw). The output is
  the raw ``[r, g, b, sigma]`` logits (Q, 4).
* Layer names are the reference's (``mlp.{i}``, ``feature``, ``sigma_out``,
  ``color_fc``, ``color_out``), so the reference's state dict
  (``tests/golden/mlp_state.npz``) loads with ``load_state_dict``.

Weights are stored the PyTorch way, (out, in); :func:`params_from_jax`
converts the JAX package's (in, out) pytree. A model with a grid encoder
carries it as the submodule ``pos_grid`` (a :class:`KPlanes`, the JAX
``params["pos_grid"]``); a frequency-encoded model has none, so its state
dict is the reference's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from nerf_sandbox_tpu_torch.device import resolve_device
from nerf_sandbox_tpu_torch.models.kplanes import KPlanes, KPlanesConfig


class NeRFConfig(NamedTuple):
    enc_pos_dim: int
    enc_dir_dim: int
    n_layers: int = 8
    hidden_dim: int = 256
    skip_pos: int = 4
    # NeRF-W appearance code width; not ported (ROADMAP P7 item 7)
    app_dim: int = 0


def trunk_in_dims(cfg: NeRFConfig) -> list[int]:
    """in_features per trunk layer, incl. the widened skip layer (mlps.py:93-102)."""
    dims = []
    in_dim = cfg.enc_pos_dim
    for idx in range(cfg.n_layers):
        dims.append(in_dim + cfg.enc_pos_dim if idx == cfg.skip_pos else in_dim)
        in_dim = cfg.hidden_dim
    return dims


def sigma_bias_for_initial_acc_opacity(initial_acc_opacity: float, near: float,
                                       far: float, activation: str = "softplus") -> float:
    """Solve activation(b) = sigma* with 1-exp(-sigma*·L) = p (mlps.py:136-176)."""
    p = float(max(1e-6, min(0.99, initial_acc_opacity)))
    L = float(max(1e-8, far - near))
    sigma_star = -math.log(1.0 - p) / L
    if (activation or "softplus").lower() == "softplus":
        return float(math.log(math.expm1(sigma_star)))
    return float(sigma_star)


def _uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=generator, dtype=torch.float32)
            * (2.0 * bound) - bound)


class NeRFMLP(nn.Module):
    """The skip MLP. ``forward(enc_pos, enc_dir, compute_dtype=None)`` → (Q, 4).

    ``grid_cfg`` (a :class:`KPlanesConfig` whose ``out_dim`` is
    ``cfg.enc_pos_dim``) adds the k-planes encoder as ``self.pos_grid``,
    drawn from the same generator after the MLP; otherwise ``pos_grid`` is
    None.
    """

    def __init__(self, cfg: NeRFConfig, *, generator: torch.Generator | None = None,
                 near: float = 2.0, far: float = 6.0,
                 initial_acc_opacity: float | None = None,
                 sigma_activation: str = "softplus",
                 grid_cfg: KPlanesConfig | None = None, device=None):
        super().__init__()
        if cfg.app_dim:
            raise NotImplementedError(
                "appearance codes (app_dim > 0) are ROADMAP queue 1, P7 item 7")
        if grid_cfg is not None and grid_cfg.out_dim != cfg.enc_pos_dim:
            raise ValueError(f"k-planes out_dim {grid_cfg.out_dim} != "
                             f"enc_pos_dim {cfg.enc_pos_dim}")
        self.cfg = cfg
        dev = resolve_device(device)
        H = cfg.hidden_dim

        def linear(fan_in, fan_out):
            return nn.utils.skip_init(nn.Linear, fan_in, fan_out, device=dev)

        self.mlp = nn.ModuleList([linear(d, H) for d in trunk_in_dims(cfg)])
        self.feature = linear(H, H)
        self.sigma_out = linear(H, 1)
        self.color_fc = linear(H + cfg.enc_dir_dim, H // 2)
        self.color_out = linear(H // 2, 3)
        self.reset_parameters(generator, near=near, far=far,
                              initial_acc_opacity=initial_acc_opacity,
                              sigma_activation=sigma_activation)
        self.pos_grid = (None if grid_cfg is None else
                         KPlanes(grid_cfg, generator=generator, device=dev))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None, *,
                         near: float = 2.0, far: float = 6.0,
                         initial_acc_opacity: float | None = None,
                         sigma_activation: str = "softplus") -> None:
        """Seeded init with the distributions of ``init_nerf_params``
        (mlp.py:86-127; reference mlps.py:178-190): trunk and color_fc
        Kaiming-uniform with relu gain, feature Kaiming-uniform with linear
        gain, zero biases; sigma_out and color_out the ``nn.Linear`` default
        U(±1/sqrt(fan_in)). Draws come from a CPU generator (seed 0 when
        none is given), so the weights do not depend on the device."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        relu_gain = math.sqrt(2.0)

        def kaiming(layer, gain):
            fan_in = layer.in_features
            layer.weight.copy_(_uniform(g, layer.weight.shape,
                                        gain * math.sqrt(3.0 / fan_in)))
            layer.bias.zero_()

        def linear_default(layer):
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.copy_(_uniform(g, layer.weight.shape, bound))
            layer.bias.copy_(_uniform(g, layer.bias.shape, bound))

        for layer in self.mlp:
            kaiming(layer, relu_gain)
        kaiming(self.feature, 1.0)
        linear_default(self.sigma_out)
        kaiming(self.color_fc, relu_gain)
        linear_default(self.color_out)
        if initial_acc_opacity is not None:
            b = sigma_bias_for_initial_acc_opacity(
                initial_acc_opacity, near=near, far=far,
                activation=sigma_activation)
            self.sigma_out.bias.fill_(b)
            self.color_out.bias.zero_()
            self.color_out.weight.mul_(0.1)

    def forward(self, enc_pos: torch.Tensor, enc_dir: torch.Tensor,
                compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """→ (Q, 4) raw [r, g, b, sigma] logits (mlps.py:192-278).

        ``compute_dtype=torch.bfloat16`` mirrors ``nerf_apply``'s bf16 mode:
        inputs, weights and biases are cast to bf16, each product is a bf16
        matrix product with fp32 accumulation (device.py) rounded to bf16,
        and the bias is added in bf16. Heads return fp32 logits either way.
        """
        ct = compute_dtype

        def lin(x, layer):
            w, b = layer.weight, layer.bias
            if ct is not None:
                x, w, b = x.to(ct), w.to(ct), b.to(ct)
            return x @ w.T + b

        h = enc_pos if ct is None else enc_pos.to(ct)
        enc_pos_c = h
        for idx, layer in enumerate(self.mlp):
            if idx == self.cfg.skip_pos:
                h = torch.cat([h, enc_pos_c], dim=-1)
            h = torch.relu(lin(h, layer))

        sigma_raw = lin(h, self.sigma_out).float()
        feature = lin(h, self.feature)
        enc_dir_c = enc_dir if ct is None else enc_dir.to(ct)
        color_h = torch.relu(lin(torch.cat([feature, enc_dir_c], dim=-1),
                                 self.color_fc))
        color_raw = lin(color_h, self.color_out).float()
        return torch.cat([color_raw, sigma_raw], dim=-1)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's params pytree (nested dicts/lists of arrays, weights
    (in, out)) → this module's state dict (weights (out, in)).

    The inverse of ``params_from_torch_state_dict`` (JAX ``mlp.py:211-228``).
    A k-planes ``pos_grid`` dict becomes ``pos_grid.<table>`` entries, array
    for array (load it into a model built with ``grid_cfg``). An IPE-trained
    model converts like any frequency model: mip-NeRF's integrated encoding
    has no parameters and keeps the frequency encoder's columns, so render
    it with ``EvalHyper(ipe=True)``.
    """
    def lin(prefix, leaf):
        return {f"{prefix}.weight": torch.from_numpy(
                    np.array(np.asarray(leaf["w"], np.float32).T, order="C")),
                f"{prefix}.bias": torch.from_numpy(
                    np.array(leaf["b"], np.float32))}

    extra = set(tree) - {"trunk", "feature", "sigma_out", "color_fc",
                         "color_out", "pos_grid"}
    if extra:
        raise NotImplementedError(
            f"parameters {sorted(extra)}: appearance codes are ROADMAP "
            "queue 1, P7 item 7")
    sd = {}
    for i, layer in enumerate(tree["trunk"]):
        sd.update(lin(f"mlp.{i}", layer))
    for name in ("feature", "sigma_out", "color_fc", "color_out"):
        sd.update(lin(name, tree[name]))
    grid = tree.get("pos_grid")
    if grid is not None:
        if not isinstance(grid, dict):
            raise NotImplementedError(
                "a hash-grid pos_grid is ROADMAP queue 1, P7 item 8")
        for name, arr in grid.items():
            sd[f"pos_grid.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd
