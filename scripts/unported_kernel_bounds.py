"""Least H100 time of the Pallas kernels the PyTorch port has not ported yet,
at the shapes their consumers give them.

    JAX_PLATFORMS=cpu python scripts/unported_kernel_bounds.py

Builds nf_tpu's image models, traces their calls abstractly
(``jax.eval_shape``: the model's arithmetic does not run) at bench.py's
image batch, records the arguments each kernel's
dispatcher receives where the kernel would be eligible, and prints, per
kernel and consumer, the bytes and operations of one model call with the
bound they give on one H100 SXM (NVIDIA's data sheet: 3.35 TB/s, 67 TFLOP/s
f32, 495 TFLOP/s TF32; SFU 16 results per SM per clock at 132 SMs and
1980 MHz).  Consumers:

* ``ops/pallas/coupling.py`` ``coupling_fwd`` (flattened half a multiple
  of 128): the forward of bench.py's IMAGE_ZOO models;
* ``ops/pallas/attention.py`` ``attention`` (L > 1): image Flow++ at
  32x32x1, forward and inverse;
* ``ops/pallas/mixlogcdf.py`` ``mix_log_cdf_inverse_pallas``: no model
  calls ``bijectors/mixlogcdf.py::mix_log_cdf_inverse`` (image Flow++
  inverts in logit space), so it is bounded at the shape its own gate
  names (``use_pallas_bisect``: B = 1024, N = 512, K = 8), for 1 and for
  its cap of 24 mixture evaluations per element.

Counting: each input read once and each output written once, in f32.
"""
from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp

import bench
from nf_tpu.config import NETWORK_DEFAULTS, NetworkConfig
from nf_tpu.core import Ctx
from nf_tpu.models import build_model

# the package exports functions of these names: take the modules themselves
attn_mod = importlib.import_module("nf_tpu.ops.pallas.attention")
coup_mod = importlib.import_module("nf_tpu.ops.pallas.coupling")

HBM = 3.35e12
F32 = 67e12
TF32 = 495e12
SFU = 132 * 16 * 1980e6


def _bound(bytes_, mac_flop, elem, trans):
    times = {"bytes": bytes_ / HBM, "operations": max((mac_flop + elem) / F32, trans / SFU)}
    by = max(times, key=times.get)
    tf32 = max(bytes_ / HBM, mac_flop / TF32, elem / F32, trans / SFU)
    return {"bytes": bytes_, "flop": mac_flop + elem, "transcendental": trans,
            "bound_ms": times[by] * 1e3, "bound_by": by, "tf32_bound_ms": tf32 * 1e3}


def _trace(name, dims, direction, **cfg_kw):
    cfg = NetworkConfig(name=name, **{**NETWORK_DEFAULTS[name], **cfg_kw})
    model = build_model(name, dims, datatype="image", cfg=cfg)
    var = model.init(jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((bench.IMG_EVAL_BATCH,) + tuple(dims), jnp.float32)
    ctx = Ctx(rng=None, train=False)
    fn = model.forward if direction == "forward" else model.inverse
    jax.eval_shape(lambda v, y: fn(v, y, ctx)[:2], var, x)


def coupling_bounds():
    calls = []
    original = coup_mod.coupling_fwd

    def spy(z0, t, raw_s, gain, bias):
        if z0.ndim == 2 and z0.shape[1] % 128 == 0:
            calls.append(tuple(z0.shape))
        return original(z0, t, raw_s, gain, bias)

    out = {}
    coup_mod.coupling_fwd = spy
    try:
        for key, spec in bench.IMAGE_ZOO.items():
            calls.clear()
            _trace(spec["network"], spec["dims"], "forward", layers=spec["layers"])
            # per element: reads z0, t, raw_s; writes y; tanh and exp; the
            # gain, bias, scale, shift and row-sum are 5 f32 operations
            elems = sum(b * n for b, n in calls)
            rows = sum(b for b, _ in calls)
            out[key] = {"calls": len(calls), "shapes": sorted(set(calls)),
                        **_bound(4 * (4 * elems + rows), 0, 5 * elems, 2 * elems)}
    finally:
        coup_mod.coupling_fwd = original
    return out


def attention_bounds():
    calls = []
    original = attn_mod.attention

    def spy(q, k, v):
        if q.shape[-2] > 1:
            calls.append(tuple(q.shape))
        return original(q, k, v)

    out = {}
    attn_mod.attention = spy
    try:
        for direction in ("forward", "inverse"):
            calls.clear()
            _trace("flow++", (32, 32, 1), direction)
            # per slice: Q K^T and P V (2 L^2 D multiply-adds each), the
            # softmax's exp per score and 3 f32 operations per score
            # (max, subtract, normalise)
            mac = sum(2 * 2 * bh * L * L * d for bh, L, d in calls)
            scores = sum(bh * L * L for bh, L, _ in calls)
            io = sum(4 * bh * L * d for bh, L, d in calls)
            out[f"flowpp-img32x1 {direction}"] = {
                "calls": len(calls), "shapes": sorted(set(calls)),
                **_bound(4 * io, mac, 3 * scores, scores)}
    finally:
        attn_mod.attention = original
    return out


def mixlogcdf_bounds(B=1024, N=512, K=8):
    # reads y and three (B, N, K) mixture tensors, writes x and the log-det;
    # one mixture evaluation is 5K + 3 transcendentals and 12K + 15 f32
    # operations per element (as chip_smoke.py counts Flow++'s)
    out = {}
    for evals in (1, 24):
        e = B * N * evals
        out[f"B={B} N={N} K={K}, {evals} evaluations per element"] = _bound(
            4 * (B * N * (2 + 3 * K) + B), 0, e * (12 * K + 15), e * (5 * K + 3))
    return out


def main():
    print(json.dumps({
        "card": "H100 SXM, NVIDIA data sheet peaks (not measured)",
        "batch": bench.IMG_EVAL_BATCH,
        "coupling_fwd (ops/pallas/coupling.py:56)": coupling_bounds(),
        "attention_pallas (ops/pallas/attention.py:60)": attention_bounds(),
        "mix_log_cdf_inverse_pallas (ops/pallas/mixlogcdf.py:119)": mixlogcdf_bounds(),
    }, indent=1))


if __name__ == "__main__":
    main()
