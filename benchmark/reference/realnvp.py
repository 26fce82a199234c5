"""Plain PyTorch RealNVP, the benchmark's reference for the `realnvp` family.

Written from the published model (Dinh et al., "Density estimation using
Real NVP", and the reference implementation's `flows/realnvp.py`), in
float32 with plain `torch` operations: no kernel, no packing, no batching
beyond what the caller hands in.  It reads the raw state the benchmark
draws (weight-norm directions and gains, biases, batch-norm statistics,
coupling gains), under the key names the served model's state dict uses,
and works every derived weight out again itself.

Two layouts:

* density (`datatype` "2d"): n x [BatchNorm(affine=False) -> AffineCoupling]
  over (B, D) rows, the coupling splitting even / odd features and its
  conditioner an MLP;
* image (`datatype` "image", NHWC): Logit(0.01, compressed), then while the
  side is above 8: n checkerboard couplings, Squeeze2d, n channelwise
  couplings; then n + 1 checkerboard couplings; Unsqueeze2d back to the
  input's side.  Conditioners are ConvNets with 3x3 convs.

Each coupling: s = tanh(raw_s) * s_log_scale + s_bias, forward
z0' = z0 * exp(s) + t, log-det sum(s).  A flow batch norm in eval mode:
y = (x - mean) / sqrt(var) * exp(log_gamma) + beta.  The base density is a
standard normal.

It computes in the dtype of the state it is handed (float32 as the
configuration states; float64 for a closer look).  `tf32=True` rounds
every matmul and conv operand to TF32 (10 mantissa
bits) before the product, with float32 sums: the arithmetic of the card's
TF32 tensor cores, here on any device.  It is the control of the output
check, one precision below what the configuration states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

WN_EPS = 1.0e-5        # weight norm: v * g / (||v|| + eps)
BN_NET_EPS = 1.0e-5    # conditioner batch norm: rsqrt(var + eps)
LOGIT_EPS = 0.01       # the image flows' Logit(0.01, compress=True)
# The conditioner head's column norm, as a share of a Kaiming-uniform one:
# at 1.0, 161 random couplings send the latents of 8-bit images to an rms of
# about 170 and saturate nearly three quarters of the sampled pixels; at 0.3
# the rms is about 3 and under 4 % saturate.
HEAD_GAIN = 0.3


# ---------------------------------------------------------------- structure
def _coupling_halves(dims, masking, odd):
    """(channels of the transformed half, channels of the conditioning
    half, the halves' (H, W) or None for rows)."""
    if len(dims) == 1:
        d = dims[0]
        n_even, n_odd = (d + 1) // 2, d // 2
        return ((n_odd, n_even) if odd else (n_even, n_odd)) + (None,)
    h, w, c = dims
    if masking == "checkerboard":
        return 2 * c, 2 * c, (h // 2, w // 2)
    return c // 2, c - c // 2, (h, w)


def layers(cfg):
    """The model as a list of steps, each a dict: kind ('logit', 'bn',
    'coupling', 'squeeze', 'unsqueeze'), its state key prefix, and its
    shapes."""
    n = cfg["network_config"]["layers"]
    dims = tuple(cfg["dims"])
    steps = []

    def block(k, dims, masking):
        for i in range(k):
            steps.append({"kind": "bn", "channels": dims[-1], "dims": dims})
            steps.append({"kind": "coupling", "dims": dims, "masking": masking,
                          "odd": i % 2 != 0})

    if cfg["datatype"] == "image":
        h, w, c = dims
        steps.append({"kind": "logit"})
        mid = (h, w, c)
        while max(mid[0], mid[1]) > 8:
            block(n, mid, "checkerboard")
            steps.append({"kind": "squeeze"})
            mid = (mid[0] // 2, mid[1] // 2, mid[2] * 4)
            block(n, mid, "channelwise")
        block(n + 1, mid, "checkerboard")
        while mid[0] != h or mid[1] != w:
            steps.append({"kind": "unsqueeze"})
            mid = (mid[0] * 2, mid[1] * 2, mid[2] // 4)
    else:
        block(n, dims, "checkerboard")
    for i, s in enumerate(steps):
        s["prefix"] = f"bijector.layers.{i}"
    return steps


def _net_specs(prefix, in_ch, out_ch, filters, k):
    """The conditioner's leaves: in-proj, two residual blocks, BN-ReLU-head.
    ``k`` is the conv's side (3) or None for a dense MLP."""
    specs = []

    def proj(p, i, o, side, gain=1.0):
        fan_in = i * (side or 1) ** 2
        shape = (o, i) if side is None else (o, i, side, side)
        gshape = (i,) if side is None else (i, side, side)
        norm = gain * math.sqrt(o / (3.0 * fan_in))    # a Kaiming-uniform column's norm
        bound = math.sqrt(1.0 / fan_in)
        specs.extend([(f"{p}.g", gshape, 0.75 * norm, 1.25 * norm),
                      (f"{p}.v", shape, -1.0, 1.0),
                      (f"{p}.b", (o,), -bound, bound)])

    def bn(p, c):
        specs.extend([(f"{p}.gamma", (c,), 0.75, 1.25), (f"{p}.beta", (c,), -0.25, 0.25),
                      (f"{p}.running_mean", (c,), -0.25, 0.25),
                      (f"{p}.running_var", (c,), 0.75, 1.25)])

    proj(f"{prefix}.layers.0", in_ch, filters, k)
    for r in (1, 2):
        rb = f"{prefix}.layers.{r}.net.layers"
        bn(f"{rb}.0", filters)
        proj(f"{rb}.2", filters, filters, k)
        bn(f"{rb}.3", filters)
        proj(f"{rb}.5", filters, filters, k)
    bn(f"{prefix}.layers.3", filters)
    proj(f"{prefix}.layers.5", filters, out_ch, None if k is None else 1, HEAD_GAIN)
    return specs


def param_specs(cfg):
    """Every leaf of the model's state: (key, shape, low, high), drawn
    uniform in [low, high] (low == high: a constant).  Off identity, at the
    scales a Kaiming-uniform init gives (the heads at ``HEAD_GAIN`` of it),
    so that every layer moves its input.  A non-affine flow batch norm keeps
    its identity log_gamma and beta, and its training caches stay unused."""
    filters = cfg["network_config"]["base_filters"]
    specs = []
    for s in layers(cfg):
        p = s["prefix"]
        if s["kind"] == "bn":
            c = (s["channels"],)
            specs += [(f"{p}.log_gamma", c, 0.0, 0.0), (f"{p}.beta", c, 0.0, 0.0),
                      (f"{p}.running_mean", c, -0.1, 0.1),
                      (f"{p}.running_var", c, 0.9, 1.1),
                      (f"{p}.batch_mean", c, 0.0, 0.0), (f"{p}.batch_var", c, 1.0, 1.0)]
        elif s["kind"] == "coupling":
            out_ch, in_ch, _ = _coupling_halves(s["dims"], s["masking"], s["odd"])
            specs += [(f"{p}.s_log_scale", (1,), -0.3, 0.3), (f"{p}.s_bias", (1,), -0.05, 0.05)]
            side = None if len(s["dims"]) == 1 else 3
            specs += _net_specs(f"{p}.net", in_ch, 2 * out_ch, filters, side)
    return specs


# ------------------------------------------------------------------- pieces
def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _weight(state, p):
    v, g = state[f"{p}.v"], state[f"{p}.g"]
    return v * (g / (torch.linalg.vector_norm(v, dim=0) + WN_EPS))[None]


def _dense(state, p, x, tf32):
    w, b = _weight(state, p), state[f"{p}.b"]
    if tf32:
        x, w = _tf32(x), _tf32(w)
    return x @ w.T + b


def _conv(state, p, x, tf32):
    """NHWC 'same' conv, stride 1."""
    w, b = _weight(state, p), state[f"{p}.b"]
    if tf32:
        x, w = _tf32(x), _tf32(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _bn_net(state, p, x):
    mean, var = state[f"{p}.running_mean"], state[f"{p}.running_var"]
    return (x - mean) / torch.sqrt(var + BN_NET_EPS) * state[f"{p}.gamma"] + state[f"{p}.beta"]


def _conditioner(state, p, x, image, tf32):
    proj = _conv if image else _dense
    h = proj(state, f"{p}.layers.0", x, tf32)
    for r in (1, 2):
        rb = f"{p}.layers.{r}.net.layers"
        u = proj(state, f"{rb}.2", torch.relu(_bn_net(state, f"{rb}.0", h)), tf32)
        u = proj(state, f"{rb}.5", torch.relu(_bn_net(state, f"{rb}.3", u)), tf32)
        h = h + u
    h = torch.relu(_bn_net(state, f"{p}.layers.3", h))
    return proj(state, f"{p}.layers.5", h, tf32)


def space_to_depth(z):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel blocks [a, b, c, d] of
    each 2x2 cell a=(0,0) b=(0,1) c=(1,0) d=(1,1)."""
    B, H, W, C = z.shape
    z = z.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(B, H // 2, W // 2, 4 * C)


def depth_to_space(z):
    B, h, w, C4 = z.shape
    z = z.reshape(B, h, w, 2, 2, C4 // 4).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(B, 2 * h, 2 * w, C4 // 4)


def _split(x, masking, odd):
    if x.dim() == 2:
        z0, z1 = x[:, 0::2], x[:, 1::2]
    elif masking == "checkerboard":
        C = x.shape[-1]
        s = space_to_depth(x)
        z0 = torch.cat([s[..., :C], s[..., 3 * C:]], dim=-1)      # cells a, d
        z1 = s[..., C:3 * C]                                      # cells b, c
    else:
        C = x.shape[-1]
        z0, z1 = x[..., :C // 2], x[..., C // 2:]
    return (z1, z0) if odd else (z0, z1)


def _merge(z0, z1, masking, odd):
    if odd:
        z0, z1 = z1, z0
    if z0.dim() == 2:
        out = z0.new_empty((z0.shape[0], z0.shape[1] + z1.shape[1]))
        out[:, 0::2], out[:, 1::2] = z0, z1
        return out
    if masking == "checkerboard":
        C = z0.shape[-1] // 2
        return depth_to_space(torch.cat([z0[..., :C], z1, z0[..., C:]], dim=-1))
    return torch.cat([z0, z1], dim=-1)


def _coupling(state, step, x, inverse, tf32):
    p = step["prefix"]
    z0, z1 = _split(x, step["masking"], step["odd"])
    raw = _conditioner(state, f"{p}.net", z1, x.dim() == 4, tf32)
    oc = z0.shape[-1]
    t, raw_s = raw[..., :oc], raw[..., oc:]
    s = torch.tanh(raw_s) * state[f"{p}.s_log_scale"] + state[f"{p}.s_bias"]
    ld = s.reshape(s.shape[0], -1).sum(dim=1)
    if inverse:
        return _merge((z0 - t) * torch.exp(-s), z1, step["masking"], step["odd"]), -ld
    return _merge(z0 * torch.exp(s) + t, z1, step["masking"], step["odd"]), ld


def _flow_bn(state, step, x, inverse):
    p = step["prefix"]
    mean, var = state[f"{p}.running_mean"], state[f"{p}.running_var"]
    lg, beta = state[f"{p}.log_gamma"], state[f"{p}.beta"]
    pixels = x[0].numel() // x.shape[-1]
    ld = ((lg - 0.5 * torch.log(var)).sum() * pixels).expand(x.shape[0])
    if inverse:
        return (x - beta) * torch.exp(-lg) * torch.sqrt(var) + mean, -ld
    return (x - mean) / torch.sqrt(var) * torch.exp(lg) + beta, ld


def _logit(x, inverse):
    """Logit(eps, compress=True): y = logit(eps + (1 - 2 eps) x)."""
    scale = 1.0 - 2.0 * LOGIT_EPS
    size = x[0].numel()
    if inverse:
        s = torch.sigmoid(x)
        ld = (x - 2.0 * F.softplus(x)).reshape(x.shape[0], -1).sum(dim=1)
        return (s - LOGIT_EPS) / scale, ld - size * math.log(scale)
    u = LOGIT_EPS + scale * x
    uc = torch.clamp(u, 1.0e-8, 1.0 - 1.0e-8)
    ld = -(torch.log(uc) + torch.log1p(-uc)).reshape(x.shape[0], -1).sum(dim=1)
    return torch.log(u) - torch.log1p(-u), ld + size * math.log(scale)


def _step(state, step, x, inverse, tf32):
    kind = step["kind"]
    if kind == "coupling":
        return _coupling(state, step, x, inverse, tf32)
    if kind == "bn":
        return _flow_bn(state, step, x, inverse)
    if kind == "logit":
        return _logit(x, inverse)
    zeros = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    to_depth = (kind == "squeeze") != inverse
    return (space_to_depth(x) if to_depth else depth_to_space(x)), zeros


def normal_logprob(z):
    z = z.reshape(z.shape[0], -1)
    return -0.5 * (z * z).sum(dim=1) - 0.5 * z.shape[1] * math.log(2.0 * math.pi)


# ----------------------------------------------------------------- requests
def _dtype(state):
    return next(iter(state.values())).dtype


@torch.no_grad()
def forward(state, cfg, x, tf32=False):
    """data -> (latent, log|det dz/dx|), in the state's dtype."""
    x = x.to(_dtype(state))
    ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for step in layers(cfg):
        x, d = _step(state, step, x, False, tf32)
        ld = ld + d
    return x, ld


@torch.no_grad()
def inverse(state, cfg, z, tf32=False):
    """latent -> (data, log-det of the inverse map), in the state's dtype."""
    z = z.to(_dtype(state))
    ld = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    for step in reversed(layers(cfg)):
        z, d = _step(state, step, z, True, tf32)
        ld = ld + d
    return z, ld


def log_prob(state, cfg, x, tf32=False):
    z, ld = forward(state, cfg, x, tf32)
    return normal_logprob(z) + ld


def sample(state, cfg, z, tf32=False):
    """(y, log p(y)) for the latents z."""
    y, ld = inverse(state, cfg, z, tf32)
    return y, normal_logprob(z) - ld
