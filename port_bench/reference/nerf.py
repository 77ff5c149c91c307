"""Plain NeRF in PyTorch: the benchmark's reference, and its control.

A frozen, independent statement of what the measured program computes,
written from the published descriptions and the configuration files:

* NeRF (Mildenhall et al., ECCV 2020): the positional encoding
  ``[x, sin(2^k x), cos(2^k x)]`` (all sines, then all cosines), the 8-layer
  ReLU trunk with the encoding concatenated before layer ``skip_pos``, the
  density head, the feature layer and the view-dependent colour head;
  stratified coarse samples jittered in their bins, inverse-CDF fine samples
  from the coarse weights, the alpha compositing with an infinite last bin
  over a white background, MSE on both levels, Adam with a cosine rate.
* The multiresolution hash encoding (Muller et al., SIGGRAPH 2022): L levels
  of resolution ``floor(N_min b^l)``, every level's corners hashed
  ``(x * 1) ^ (y * 2654435761) ^ (z * 805459861) mod T``, trilinear weights,
  levels side by side.

It imports torch only: nothing of the measured program, and it takes
nothing that the program made. Parameters are named as the program names
them (``mlp.{i}.weight`` ...), so the benchmark can hand the same weights to
both sides.

``mode`` selects the precision of every matrix product: ``"fp32"`` is the
reference (TF32 off, the caller's job: :func:`strict_fp32`); ``"bf16"`` the
configuration's own; ``"fp8"`` the control, every product's operands
rounded to float8 with a per-tensor scale (e4m3 forward, the gradient e5m2
backward), accumulated in fp32: the next precision below the
configuration's bf16.
"""

from __future__ import annotations

import math

import torch

PRIMES = (1, 2654435761, 805459861)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def strict_fp32() -> None:
    """True fp32 matrix products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- sizes

def settings(flags: dict) -> dict:
    """The flags of a configuration with what the reference derives from
    them: ``near`` / ``far`` (``near_world`` / ``far_world``), and the cosine
    schedule's ``eta_min`` and ``t_max`` (``lr_scheduler_params``)."""
    import json
    sched = flags.get("lr_scheduler_params") or "{}"
    sched = json.loads(sched) if isinstance(sched, str) else dict(sched)
    if flags.get("lr_scheduler", "cosine") != "cosine" or "T_max" not in sched:
        raise ValueError("the reference follows a cosine schedule with a T_max")
    return {**flags, "near": float(flags["near_world"]), "far": float(flags["far_world"]),
            "eta_min": float(sched.get("eta_min", 0.0)), "t_max": int(sched["T_max"])}


def model_dims(cfg: dict) -> dict:
    """The MLP's widths from a configuration's flags."""
    hashgrid = cfg.get("encoder") == "hashgrid"
    if hashgrid:
        pos = int(cfg["hash_levels"]) * int(cfg["hash_features"])
    else:
        pos = 3 + 6 * int(cfg["pos_num_freqs"])
    return {"pos": pos, "dir": 3 + 6 * int(cfg["dir_num_freqs"]),
            "hidden": int(cfg["hidden_dim"]), "layers": int(cfg["n_layers"]),
            "skip": int(cfg["skip_pos"])}


def layer_shapes(cfg: dict) -> list:
    """[(name, (out, in), init)] of one model's linear layers, in order."""
    d = model_dims(cfg)
    H = d["hidden"]
    out = []
    in_dim = d["pos"]
    for i in range(d["layers"]):
        fan_in = in_dim + d["pos"] if i == d["skip"] else in_dim
        out.append((f"mlp.{i}", (H, fan_in), "relu"))
        in_dim = H
    out += [("feature", (H, H), "linear"), ("sigma_out", (1, H), "default"),
            ("color_fc", (H // 2, H + d["dir"]), "relu"),
            ("color_out", (3, H // 2), "default")]
    return out


def table_shape(cfg: dict):
    """(L, T, F) of a hash grid's tables, or None."""
    if cfg.get("encoder") != "hashgrid":
        return None
    return (int(cfg["hash_levels"]), 1 << int(cfg["hash_log2_size"]),
            int(cfg["hash_features"]))


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of both models, ``c.`` coarse and ``f.`` fine."""
    shapes = {}
    for m in ("c", "f"):
        for name, (o, i), _ in layer_shapes(cfg):
            shapes[f"{m}.{name}.weight"] = (o, i)
            shapes[f"{m}.{name}.bias"] = (o,)
        tab = table_shape(cfg)
        if tab is not None:
            shapes[f"{m}.pos_grid.tables"] = tab
    return shapes


def init_params(cfg: dict, seed: int, device) -> dict:
    """Both models' parameters from ``seed``, made on ``device`` in one draw
    of uniforms: trunk and colour layer Kaiming-uniform with the ReLU gain,
    the feature layer with gain 1, biases zero, the two output heads
    U(+-1/sqrt(fan_in)), the colour head's bias alike and the density
    head's set by :func:`density_bias`, hash tables U(+-1e-4)."""
    shapes = param_shapes(cfg)
    n = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    u = torch.rand(n, generator=g, device=device) * 2.0 - 1.0
    kinds = {name: kind for name, _, kind in layer_shapes(cfg)}
    params, off = {}, 0
    for key, shape in shapes.items():
        size = math.prod(shape)
        x = u[off:off + size].view(shape)
        off += size
        layer, what = key.split(".", 1)[1].rsplit(".", 1)
        if layer == "pos_grid":
            params[key] = x * 1e-4
            continue
        kind = kinds[layer]
        fan_in = shapes[key.rsplit(".", 1)[0] + ".weight"][1]
        if kind == "default":
            params[key] = x / math.sqrt(fan_in)
        elif what == "bias":
            params[key] = torch.zeros_like(x)
        else:
            gain = math.sqrt(2.0) if kind == "relu" else 1.0
            params[key] = x * (gain * math.sqrt(3.0 / fan_in))
    for prefix in ("c.", "f."):
        params[prefix + "sigma_out.bias"] = density_bias(params, prefix, cfg, g, device)
    return params


def density_bias(params: dict, prefix: str, cfg: dict, g, device, n: int = 4096):
    """The density head's bias that puts the median density logit of ``n``
    points drawn in the scene's box at 0: half of space holds density, for
    every seed. Drawn otherwise, the sign of one sum decides whether all of
    a seed's frames are dense or empty."""
    box = float(cfg.get("hash_aabb_scale", 1.5))
    pts = (torch.rand((n, 3), generator=g, device=device) * 2.0 - 1.0) * box
    dirs = torch.randn((n, 3), generator=g, device=device)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    bias = params[prefix + "sigma_out.bias"]
    params[prefix + "sigma_out.bias"] = torch.zeros_like(bias)
    with torch.no_grad():
        if cfg.get("encoder") == "hashgrid":
            enc = hash_encode(params[prefix + "pos_grid.tables"], pts, cfg)
        else:
            enc = posenc(pts, int(cfg["pos_num_freqs"]))
        _, sigma = mlp(params, prefix, enc, posenc(dirs, int(cfg["dir_num_freqs"])), cfg,
                       "fp32")
    return torch.full_like(bias, -float(sigma.median()))


# ---------------------------------------------------------------- products

def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 with a per-tensor scale (its largest entry at
    the format's largest), back in fp32."""
    top = torch.finfo(dtype).max
    scale = torch.clamp(x.abs().amax(), min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _LinearFp8(torch.autograd.Function):
    """``x @ w.T`` with every product's operands in float8, as an fp8
    training recipe computes it: e4m3 inputs and weights forward, the
    incoming gradient in e5m2 backward, each tensor with its own scale,
    accumulated in fp32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq, gq.T @ xq


def linear(x, w, b, mode: str):
    """``x @ w.T + b`` in the mode's precision (``bf16``: the configuration's
    own, bf16 operands, fp32 accumulation, the sum and the bias in bf16)."""
    if mode == "fp8":
        return _LinearFp8.apply(x, w) + b
    if mode == "bf16":
        bf = torch.bfloat16
        return (x.to(bf) @ w.to(bf).T + b.to(bf)).float()
    if mode != "fp32":
        raise ValueError(f"unknown precision {mode!r}")
    return x @ w.T + b


# ---------------------------------------------------------------- encoders

def posenc(x, n_freqs: int):
    """(..., 3) → (..., 3 + 6F): ``[x, sin(2^k x) for k, cos(2^k x) for k]``."""
    bands = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    xb = x[..., None, :] * bands[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def level_resolutions(cfg: dict) -> list:
    L, lo, hi = int(cfg["hash_levels"]), int(cfg["hash_base_res"]), int(cfg["hash_max_res"])
    if L == 1:
        return [lo]
    b = math.exp((math.log(hi) - math.log(lo)) / (L - 1))
    return [int(math.floor(lo * b ** lvl)) for lvl in range(L)]


def hash_encode(tables, pts, cfg: dict):
    """(Q, 3) world points → (Q, L·F), level-major, every level hashed."""
    L, T, F = tables.shape
    aabb = float(cfg["hash_aabb_scale"])
    x01 = torch.clamp(pts / (2.0 * aabb) + 0.5, 0.0, 1.0)
    outs = []
    for lvl, res in enumerate(level_resolutions(cfg)):
        xl = x01 * float(res - 1)
        x0 = torch.floor(xl)
        frac = xl - x0
        base = x0.to(torch.int64)
        acc = torch.zeros((pts.shape[0], F), device=pts.device)
        for corner in range(8):
            bits = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
            h = torch.zeros_like(base[:, 0])
            w = torch.ones_like(frac[:, 0])
            for axis in range(3):
                h = h ^ ((base[:, axis] + bits[axis]) * PRIMES[axis])
                w = w * (frac[:, axis] if bits[axis] else 1.0 - frac[:, axis])
            acc = acc + w[:, None] * tables[lvl][h & (T - 1)]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------- model

def mlp(p: dict, prefix: str, enc_pos, enc_dir, cfg: dict, mode: str):
    """→ (rgb logits (Q, 3), sigma logit (Q,))."""
    d = model_dims(cfg)

    def lin(x, name):
        return linear(x, p[f"{prefix}{name}.weight"], p[f"{prefix}{name}.bias"], mode)

    h = enc_pos
    for i in range(d["layers"]):
        if i == d["skip"]:
            h = torch.cat([h, enc_pos], dim=-1)
        h = torch.relu(lin(h, f"mlp.{i}"))
    sigma = lin(h, "sigma_out")[:, 0]
    feat = lin(h, "feature")
    color = torch.relu(lin(torch.cat([feat, enc_dir], dim=-1), "color_fc"))
    return lin(color, "color_out"), sigma


def composite(rgb, sigma, z, ray_norm, white_bkgd: bool = True):
    """Alpha compositing with an infinite last bin → (rgb, weights, acc,
    depth)."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    deltas = deltas * ray_norm[:, None]
    alpha = 1.0 - torch.exp(-torch.clamp(sigma * deltas, 0.0, 60.0))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = torch.nan_to_num(trans * alpha, nan=0.0, posinf=0.0, neginf=0.0)
    acc = torch.clamp(w.sum(-1), 0.0, 1.0)
    depth = (w * z).sum(-1) / (acc + 1e-10)
    comp = (w[..., None] * rgb).sum(-2)
    if white_bkgd:
        comp = comp + (1.0 - acc)[:, None]
    comp = torch.clamp(torch.nan_to_num(comp, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)
    return comp, w, acc, depth


def march(p: dict, prefix: str, rays: dict, z, cfg: dict, mode: str, noise=None):
    """One model's pass over rays at samples ``z`` (B, N) → (rgb, weights,
    acc, depth, the last sample's density logit: where it is near 0 the
    infinite last bin's opacity flips on the rounding of the logit)."""
    B, N = z.shape
    pts = rays["o"][:, None, :] + rays["d"][:, None, :] * (z * rays["norm"][:, None])[..., None]
    pts = pts.reshape(-1, 3)
    if cfg.get("encoder") == "hashgrid":
        enc_pos = hash_encode(p[f"{prefix}pos_grid.tables"], pts, cfg)
    else:
        enc_pos = posenc(pts, int(cfg["pos_num_freqs"]))
    vd = rays["d"] / torch.clamp(rays["d"].norm(dim=-1, keepdim=True), min=1e-12)
    enc_dir = posenc(vd[:, None, :].expand(B, N, 3).reshape(-1, 3),
                     int(cfg["dir_num_freqs"]))
    rgb, sigma = mlp(p, prefix, enc_pos, enc_dir, cfg, mode)
    rgb = torch.sigmoid(rgb).reshape(B, N, 3)
    sigma = sigma.reshape(B, N)
    if noise is not None:
        sigma = sigma + noise * float(cfg["raw_noise_std"])
    return composite(rgb, torch.relu(sigma), z, rays["norm"],
                     bool(cfg.get("white_bkgd", True))) + (sigma[:, -1],)


# ---------------------------------------------------------------- sampling

def coarse_z(cfg: dict, B: int, device, u=None):
    """``nc`` samples evenly over [near, far], each jittered in its bin by
    ``u`` (B, nc) when given."""
    n, near, far = int(cfg["nc"]), float(cfg["near"]), float(cfg["far"])
    t = torch.arange(n, dtype=torch.float32, device=device) / (n - 1)
    z = (near * (1.0 - t) + far * t).expand(B, n)
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    lo = torch.cat([z[:, :1], mids], -1)
    hi = torch.cat([mids, z[:, -1:]], -1)
    return lo + (hi - lo) * u


def fine_z(z, w, n: int, u=None):
    """``n`` inverse-CDF samples of the piecewise-constant density whose bins
    are the midpoints of ``z`` and whose weights are the interval means of
    ``w`` (+1e-5); ``u`` (B, n) uniforms, or evenly spaced ones when None."""
    B = z.shape[0]
    mids = 0.5 * (z[:, 1:] + z[:, :-1])                         # (B, M)
    wb = (0.5 * (w[:, 1:] + w[:, :-1])).detach() + 1e-5
    M = mids.shape[-1]
    edges = torch.cat([mids[:, :1] - 0.5 * (mids[:, 1:2] - mids[:, :1]),
                       0.5 * (mids[:, 1:] + mids[:, :-1]),
                       mids[:, -1:] + 0.5 * (mids[:, -1:] - mids[:, -2:-1])], -1)
    wb = torch.clamp(wb + 1e-5, min=0.0)
    cdf = torch.cumsum(wb / wb.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)    # (B, M + 1)
    if u is None:
        u = (torch.arange(n, dtype=torch.float32, device=z.device) / (n - 1)).expand(B, n)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, 0, M)
    above = torch.clamp(idx, 1, M)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b0, b1 = torch.gather(edges, 1, below), torch.gather(edges, 1, above)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


def render_rays(p: dict, rays: dict, cfg: dict, mode: str, draws: dict | None = None):
    """Coarse and fine passes over a batch of rays → (coarse, fine)
    composites, each :func:`march`'s. ``draws`` (training): the
    jitter ``u_strat``, the noise ``noise_c`` / ``noise_f`` and the
    inverse-CDF uniforms ``u_pdf``; None renders as an eval does."""
    d = draws or {}
    B = rays["o"].shape[0]
    zc = coarse_z(cfg, B, rays["o"].device, d.get("u_strat"))
    coarse = march(p, "c.", rays, zc, cfg, mode, d.get("noise_c"))
    zf = fine_z(zc, coarse[1], int(cfg["nf"]), d.get("u_pdf"))
    z_all = torch.sort(torch.cat([zc, zf.detach()], -1), -1).values
    fine = march(p, "f.", rays, z_all, cfg, mode, d.get("noise_f"))
    return coarse, fine


def camera_rays(K, c2w, xs, ys):
    """OpenGL pinhole rays through pixel centres: per-ray ``K`` (B, 3, 3) and
    ``c2w`` (B, 3, 4) or one each → {o, d (unit), norm (of the raw dir)}."""
    x = (xs.to(torch.float32) + 0.5 - K[..., 0, 2]) / K[..., 0, 0]
    y = (ys.to(torch.float32) + 0.5 - K[..., 1, 2]) / K[..., 1, 1]
    dirs = torch.stack([x, -y, -torch.ones_like(x)], -1)
    R, t = c2w[..., :3, :3], c2w[..., :3, 3]
    d = (dirs[..., None, :] * R).sum(-1)
    norm = d.norm(dim=-1)
    return {"o": t.expand(d.shape).contiguous(), "d": d / (norm[:, None] + 1e-9),
            "norm": norm}


# ---------------------------------------------------------------- training

def cosine_lr(lr: float, eta_min: float, t_max: int, count: int) -> float:
    k = min(count, t_max)
    alpha = eta_min / lr
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * k / t_max)) + alpha)


def lr_of(cfg: dict, name: str, count: int) -> float:
    """The Adam rate of parameter ``name`` for update number ``count`` (0
    first): the grid tables take ``lr_grid`` when it is set, the cosine's
    floor scaled alike."""
    lr, eta = float(cfg["lr"]), float(cfg["eta_min"])
    if name.endswith("pos_grid.tables") and float(cfg.get("lr_grid", 0.0)) > 0:
        g = float(cfg["lr_grid"])
        lr, eta = g, eta * g / lr
    return cosine_lr(lr, eta, int(cfg["t_max"]), count)


def batch_of(scene: dict, draws: dict) -> tuple:
    """The drawn pixels' target colours (RGBA over white) and rays."""
    fids, ys, xs = draws["fids"], draws["ys"], draws["xs"]
    px = scene["images"][fids, ys, xs].to(torch.float32) / 255.0
    a = px[:, 3:4]
    target = px[:, :3] * a + (1.0 - a)
    return target, camera_rays(scene["K"][fids], scene["c2w"][fids], xs, ys)


def train_step(params: dict, adam: dict, scene: dict, draws: dict, cfg: dict,
               mode: str = "fp32", rows=None, loss_scale: float = 1.0,
               frozen: bool = False) -> dict:
    """One optimizer step on ``params`` / ``adam`` ({"mu", "nu", "count"}),
    updated in place → {"loss", "grads"}. ``rows``: a slice of the batch
    that alone makes the loss, and ``loss_scale`` a factor on it (the
    faults a check must catch); None and 1 take every ray as it is.
    ``frozen``: the step computes and returns, but leaves ``params`` as
    they were (a step that returns its state unchanged)."""
    target, rays = batch_of(scene, draws)
    d = dict(draws)
    if rows is not None:
        target = target[rows]
        rays = {k: v[rows] for k, v in rays.items()}
        d = {k: v[rows] for k, v in d.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    coarse, fine = render_rays(leaves, rays, cfg, mode, d)
    tgt = torch.clamp(target, 0.0, 1.0)
    loss = (((coarse[0] - tgt) ** 2).mean() + ((fine[0] - tgt) ** 2).mean()) * loss_scale
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    count = adam["count"]
    with torch.no_grad():
        for k, g in grads.items():
            mu = adam["mu"][k].mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu = adam["nu"][k].mul_(ADAM_B2).add_(g * g, alpha=1.0 - ADAM_B2)
            mu_hat = mu / (1.0 - ADAM_B1 ** (count + 1))
            nu_hat = nu / (1.0 - ADAM_B2 ** (count + 1))
            if not frozen:
                params[k] = params[k] - lr_of(cfg, k, count) * mu_hat / (nu_hat.sqrt() + ADAM_EPS)
    adam["count"] = count + 1
    return {"loss": float(loss.detach()), "grads": grads}


def new_adam(params: dict) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0}
