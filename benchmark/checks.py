"""The output check: the served program's answers against the plain
reference, request by request.

Every request the generator marked (a seeded sample of each kind) keeps its
answer through the window.  Once the window has closed, the reference
recomputes each from the same input (a `log_prob` request's rows) or the
same latents (a `sample` request's generator, seeded again), in blocks of
rows, and three numbers are compared, each the largest over the requests:

* `logp_gap`: max |log p - reference log p| over a log_prob request's rows,
  over the largest |log N(z)| + |log det| of the reference's rows: the size
  of the two terms log p sums, which cancel to a small log p on some
  states, so that float32's rounding of the terms sets the gap;
* `sample_logp_gap`: the same for the log p a sample request returns;
* `sample_x_gap`: max |y - reference y| over the largest |reference y|.

An answer of the wrong shape, or not finite where the reference is, reads
infinite.  A run is correct when every number is within its limit
(`limits/<config>.json`) and no request failed.
"""
from __future__ import annotations

import contextlib
import math

import torch

NUMBERS = ("logp_gap", "sample_logp_gap", "sample_x_gap")


def _gap(got, want, scale=None) -> float:
    """max |got - want| over `scale` (default: the largest |want|)."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    got, want = got.to(torch.float64), want.to(torch.float64)
    if not bool(torch.isfinite(got[torch.isfinite(want)]).all()):
        return math.inf
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(scale, 1e-30)


def _logp(reference, z, ld, sign):
    """(log p, |log N(z)| + |log det|) of each row: log p and the size of
    the two terms it sums."""
    base = reference.normal_logprob(z)
    return base + sign * ld, base.abs() + ld.abs()


def latents(seed: int, rows: int, dims, device) -> torch.Tensor:
    """The latents a sample request's generator gives: seeded again, drawn
    as `torch.randn` on the generator's device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((rows,) + tuple(dims), generator=g, device=device, dtype=torch.float32)


def _blocks(n: int, block: int):
    return [(i, min(n, i + block)) for i in range(0, n, block)]


@torch.no_grad()
def readings(kept, reference, cfg, params, traffic, block_rows: int, answer=None) -> dict:
    """{number: reading} over the kept requests.  `kept` is
    [(request, answer)]; `answer(request)` (a control) replaces the kept
    answers when given."""
    dims, device = tuple(cfg["dims"]), traffic.device
    with tf32_backends(False):
        return _readings(kept, reference, cfg, params, traffic, block_rows, answer, dims, device)


def _readings(kept, reference, cfg, params, traffic, block_rows, answer, dims, device):
    out = {k: 0.0 for k in NUMBERS}
    seen = {k: False for k in NUMBERS}
    for req, got in kept:
        if answer is not None:
            got = answer(req)
        spans = _blocks(req.rows, block_rows)
        if req.kind == "log_prob":
            x = traffic.input(req)
            lps, terms = zip(*(_logp(reference, *reference.forward(params, cfg, x[a:b]), 1)
                               for a, b in spans))
            gap = _gap(got, torch.cat(lps), float(torch.cat(terms).max()))
            out["logp_gap"] = max(out["logp_gap"], gap)
            seen["logp_gap"] = True
        else:
            z = latents(req.seed, req.rows, dims, device)
            ys, lps, terms = [], [], []
            for a, b in spans:
                yb, ld = reference.inverse(params, cfg, z[a:b])
                lp, term = _logp(reference, z[a:b], ld, -1)
                ys.append(yb)
                lps.append(lp)
                terms.append(term)
            y, lp = (None, None) if not isinstance(got, tuple) or len(got) != 2 else got
            out["sample_x_gap"] = max(out["sample_x_gap"], _gap(y, torch.cat(ys)))
            gap = _gap(lp, torch.cat(lps), float(torch.cat(terms).max()))
            out["sample_logp_gap"] = max(out["sample_logp_gap"], gap)
            seen["sample_x_gap"] = seen["sample_logp_gap"] = True
    return {k: v for k, v in out.items() if seen[k]}


@contextlib.contextmanager
def tf32_backends(allow: bool = True):
    """cuBLAS and cuDNN allowed TF32 for float32 products (`allow`, as the
    card's own defaults would have it) or held to float32, and set back
    after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def control_answer(reference, cfg, params, traffic, block_rows: int, emulate: bool):
    """The control's answers: the reference put in the program's place and
    computed in TF32, one precision below the configuration's float32:
    with TF32 allowed to cuBLAS and cuDNN (on the card), or with its
    operands rounded to TF32 by the reference itself (`emulate`, any
    device)."""
    dims = tuple(cfg["dims"])

    def answer(req):
        spans = _blocks(req.rows, block_rows)
        with tf32_backends(not emulate):
            if req.kind == "log_prob":
                x = traffic.input(req)
                return torch.cat([reference.log_prob(params, cfg, x[a:b], tf32=emulate)
                                  for a, b in spans])
            z = latents(req.seed, req.rows, dims, traffic.device)
            ys, lps = zip(*(reference.sample(params, cfg, z[a:b], tf32=emulate)
                            for a, b in spans))
        return torch.cat(ys), torch.cat(lps)
    return answer


def verdict(read: dict, limits: dict):
    """(correct, {number: {"value", "limit"}})."""
    table = {k: {"value": read[k], "limit": limits[k]} for k in NUMBERS if k in read}
    ok = bool(table) and all(v["value"] <= v["limit"] for v in table.values())
    return ok, table

