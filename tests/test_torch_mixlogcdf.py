"""The port's probability-space mixture-CDF functions against nf_tpu's, on
the CPU.

* ``mix_cdf``, ``mix_log_cdf_forward``, ``logistic_logpdf`` and
  ``mix_logistic_logpdf``: atol 2e-5, rtol 1e-6;
* ``mix_log_cdf_inverse`` (the plain Newton a CPU tensor takes) against
  nf_tpu's ``mix_log_cdf_inverse`` and its Pallas kernel
  ``mix_log_cdf_inverse_pallas`` in interpret mode at (4, 128, 8), inputs
  as tests/test_pallas.py makes them: x atol 1e-4, log-det atol 1e-3, and
  the round trip to x within 1e-3, the tolerances nf_tpu holds its kernel
  to (two Newton solves meet the root only within XTOL);
* the same at an image shape (B, H, W, C) with K last;
* csrc/mixlogcdf.cu's early exit (a thread leaves the loop once its
  element is done) walked in PyTorch: the same x, bit for bit, as the
  fixed 24 trips, and the trips ``_newton_solve`` counts;
* csrc/mixlogcdf.cu's schedule walked in PyTorch: the warps' parts of
  each block's rows, lane refill (a lane whose element is done takes the
  next one of its warp's part), x bit for bit ``_newton_solve``'s, each
  warp's trips as ``part_trips`` counts them, and the log-det summed in the
  kernel's fixed order within rtol 1e-6 of the plain one;
* the plain version against nf_tpu's Pallas kernel in interpret mode at
  K = 1, 33 and 64 (the kernel takes any K);
* the wrapper: no launch for a CPU tensor, the kernel's entry refuses CPU
  tensors, the components' walk in chunks of 8 for any K, and the Function
  has no gradient.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal

from nf_tpu.bijectors import mixlogcdf as jm
from nf_tpu.ops import math as jmath
from nf_tpu_torch.bijectors import mixlogcdf as tm
from nf_tpu_torch.ops import math as tmath
from nf_tpu_torch.ops.cuda import mixlogcdf as cm

# the package exports a function of this name: take the module itself
jpallas = importlib.import_module("nf_tpu.ops.pallas.mixlogcdf")
ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, shape, K):
    """As tests/test_pallas.py: x = 2 N(0, 1), logpi = log_softmax(N(0, 1)),
    mu = N(0, 1), s = 0.3 N(0, 1); y = mix_log_cdf_forward(x)."""
    x = normal(seed, shape, 2.0)
    logpi = np.asarray(jax.nn.log_softmax(normal(seed + 1, shape + (K,)), axis=-1))
    mu = normal(seed + 2, shape + (K,))
    s = normal(seed + 3, shape + (K,), 0.3)
    y, _ = jm.mix_log_cdf_forward(x, logpi, mu, s)
    return x, np.asarray(y), logpi, mu, s


@pytest.mark.parametrize("shape,K", [((4, 128), 8), ((3, 4, 4, 2), 5)])
def test_forward_functions_match_nf_tpu(shape, K):
    x, _, logpi, mu, s = _inputs(1, shape, K)
    close(tm.mix_cdf(_t(x), _t(logpi), _t(mu), _t(s)), jm.mix_cdf(x, logpi, mu, s), ATOL, 1e-6)
    y, ld = tm.mix_log_cdf_forward(_t(x), _t(logpi), _t(mu), _t(s))
    jy, jld = jm.mix_log_cdf_forward(x, logpi, mu, s)
    close(y, jy, ATOL, 1e-6)
    close(ld, jld, ATOL, 1e-6)
    close(tmath.logistic_logpdf(_t(x)[..., None], _t(mu), _t(s)),
          jmath.logistic_logpdf(x[..., None], mu, s), ATOL, 1e-6)
    close(tmath.mix_logistic_logpdf(_t(x), _t(logpi), _t(mu), _t(s)),
          jmath.mix_logistic_logpdf(x, logpi, mu, s), ATOL, 1e-6)


def test_inverse_matches_nf_tpu_and_pallas_interpret():
    x, y, logpi, mu, s = _inputs(2, (4, 128), 8)
    got_x, got_ld = tm.mix_log_cdf_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    jx, jld = jm.mix_log_cdf_inverse(y, logpi, mu, s)
    px, pld = jpallas.mix_log_cdf_inverse_pallas(y, logpi, mu, s, interpret=True)
    for want_x, want_ld in ((jx, jld), (px, pld)):
        close(got_x, want_x, 1e-4, 1e-4)
        close(got_ld, want_ld, 1e-3, 1e-4)
    close(got_x, x, 1e-3)


def test_inverse_at_an_image_shape():
    x, y, logpi, mu, s = _inputs(3, (3, 4, 4, 2), 5)
    got_x, got_ld = tm.mix_log_cdf_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    jx, jld = jm.mix_log_cdf_inverse(y, logpi, mu, s)
    assert got_x.shape == y.shape and got_ld.shape == (3,)
    close(got_x, jx, 1e-4, 1e-4)
    close(got_ld, jld, 1e-3, 1e-4)
    close(got_x, x, 1e-3)


def _early_exit_solve(y, logpi, mu, s):
    """csrc/mixlogcdf.cu's loop in PyTorch: each element leaves at the
    first trip whose done test passes, keeping its x."""
    pi, inv = torch.exp(logpi), torch.exp(-s)
    use_lo = y < 0.5
    ly = torch.log(torch.clamp(y, min=tm.TINY))
    l1y = torch.log(torch.clamp(1.0 - y, min=tm.TINY))
    x = torch.zeros_like(y)
    lo, hi = torch.full_like(y, -tm.SPAN), torch.full_like(y, tm.SPAN)
    dxold = torch.full_like(y, 2.0 * tm.SPAN)
    live = torch.ones_like(y, dtype=torch.bool)
    trips = torch.zeros_like(y, dtype=torch.int64)
    for _ in range(tm.N_ITERS):
        trips += live
        sg = torch.sigmoid((x[..., None] - mu) * inv)
        cdf = tm._component_sum(pi * sg)
        pdf = tm._component_sum(pi * inv * sg * (1.0 - sg))
        fraw = cdf - y
        lo = torch.where(live & (fraw < 0), x, lo)
        hi = torch.where(live & (fraw >= 0), x, hi)
        c = torch.clamp(cdf, tm.TINY, 1.0 - 1.0e-7)
        f = torch.where(use_lo, torch.log(c) - ly, l1y - torch.log1p(-c))
        df = torch.clamp(torch.where(use_lo, pdf / c, pdf / (1.0 - c)), min=tm.TINY)
        dx = f / df
        xn = x - dx
        use_bis = ((xn <= lo) | (xn >= hi) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
        live = live & ~((torch.abs(dx) <= tm.XTOL) | ((hi - lo) <= tm.XTOL))
        dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
        xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
        x = torch.where(live, xn, x)
        dxold = torch.where(live, dx, dxold)
    return x, trips


def test_kernel_early_exit_gives_the_fixed_trip_result():
    """The same x, bit for bit, and ``_newton_solve``'s ``evaluations``
    count the trips the early exit runs."""
    _, y, logpi, mu, s = _inputs(4, (8, 256), 8)
    args = [_t(a) for a in (y, logpi, mu, s)]
    x, trips = _early_exit_solve(*args)
    counts = []
    assert torch.equal(x, tm._newton_solve(*args, evaluations=counts))
    assert torch.equal(counts[0], trips) and 1 <= int(trips.min()) < int(trips.max()) <= 24


@pytest.mark.parametrize("K", [1, 33, 64])
def test_inverse_matches_pallas_interpret_at_any_k(K):
    x, y, logpi, mu, s = _inputs(6 + K, (3, 128), K)
    got_x, got_ld = tm.mix_log_cdf_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    px, pld = jpallas.mix_log_cdf_inverse_pallas(y, logpi, mu, s, interpret=True)
    close(got_x, px, 1e-4, 1e-4)
    close(got_ld, pld, 1e-3, 1e-4)
    close(got_x, x, 1e-3)


def _refill_walk(y, logpi, mu, s, rows):
    """csrc/mixlogcdf.cu's schedule in PyTorch.  Each warp's part
    (``warp_parts``) is handed out to its 32 lanes in order; at each trip
    the lanes without an element take the next ones, in lane order; every
    element held by a lane runs one Newton trip (the arithmetic on the full
    (B, N) tensors, kept only for the held elements, so each element sees
    the same operations as in ``_newton_solve``) and leaves its lane at its
    first done trip or its 24th.  Returns (x, each warp's trips, each
    element's evaluations)."""
    B, N = y.shape
    parts = cm.warp_parts(B, N, rows)
    nxt = torch.tensor([a for a, _ in parts])
    end = torch.tensor([b for _, b in parts])
    lanes = torch.full((len(parts), 32), -1, dtype=torch.int64)
    trips = torch.zeros(len(parts), dtype=torch.int64)
    evals = torch.zeros(B * N, dtype=torch.int64)
    pi, inv = torch.exp(logpi), torch.exp(-s)
    use_lo = y < 0.5
    ly = torch.log(torch.clamp(y, min=tm.TINY))
    l1y = torch.log(torch.clamp(1.0 - y, min=tm.TINY))
    x = torch.zeros_like(y)
    lo, hi = torch.full_like(y, -tm.SPAN), torch.full_like(y, tm.SPAN)
    dxold = torch.full_like(y, 2.0 * tm.SPAN)
    while True:
        need = lanes < 0
        cand = nxt[:, None] + torch.cumsum(need, 1) - need.long()
        lanes = torch.where(need & (cand < end[:, None]), cand, lanes)
        nxt = nxt + need.sum(1)
        held = lanes >= 0
        if not bool(held.any()):
            break
        trips += held.any(1)
        act = torch.zeros(B * N, dtype=torch.bool)
        act[lanes[held]] = True
        evals += act
        act = act.view(B, N)
        sg = torch.sigmoid((x[..., None] - mu) * inv)
        cdf = tm._component_sum(pi * sg)
        pdf = tm._component_sum(pi * inv * sg * (1.0 - sg))
        fraw = cdf - y
        lo_n = torch.where(fraw < 0, x, lo)
        hi_n = torch.where(fraw >= 0, x, hi)
        c = torch.clamp(cdf, tm.TINY, 1.0 - 1.0e-7)
        f = torch.where(use_lo, torch.log(c) - ly, l1y - torch.log1p(-c))
        df = torch.clamp(torch.where(use_lo, pdf / c, pdf / (1.0 - c)), min=tm.TINY)
        dx = f / df
        xn = x - dx
        use_bis = ((xn <= lo_n) | (xn >= hi_n) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
        done = (torch.abs(dx) <= tm.XTOL) | ((hi_n - lo_n) <= tm.XTOL)
        dx = torch.where(use_bis, (hi_n - lo_n) * 0.5, dx)
        xn = torch.where(use_bis, (lo_n + hi_n) * 0.5, xn)
        lo, hi = torch.where(act, lo_n, lo), torch.where(act, hi_n, hi)
        x = torch.where(act & ~done, xn, x)
        dxold = torch.where(act & ~done, dx, dxold)
        leave = (done | (evals.view(B, N) == tm.N_ITERS)).view(-1)
        lanes = torch.where(held & leave[lanes.clamp(min=0)], -1, lanes)
    return x, trips, evals.view(B, N)


def _fixed_order_logdet(lp):
    """The kernel's row sums of the log pdf lp (B, N): per piece of CHUNK
    elements, lane l adds elements l, l + 32, ... in turn, then an xor
    butterfly (16, 8, 4, 2, 1) over the lanes; the pieces in order."""
    out = []
    lane = torch.arange(32)
    for row in lp:
        acc = torch.zeros((), dtype=lp.dtype)
        for c0 in range(0, row.numel(), cm.CHUNK):
            piece = row[c0:c0 + cm.CHUNK]
            v = torch.zeros(32, dtype=lp.dtype)
            for j in range(0, piece.numel(), 32):
                v[:piece[j:j + 32].numel()] += piece[j:j + 32]
            for o in (16, 8, 4, 2, 1):
                v = v + v[lane ^ o]
            acc = acc + v[0]
        out.append(-acc)
    return torch.stack(out)


@pytest.mark.parametrize("B,N,K,rows", [(8, 256, 8, 2), (7, 200, 12, 2), (2, 2100, 3, 1)])
def test_refill_schedule_walk(B, N, K, rows):
    """The lane-refill schedule gives ``_newton_solve``'s x bit for bit, each
    element the evaluations it counts, each warp the trips ``part_trips``
    counts (``warp_evaluations`` their lane slots), and the fixed-order
    log-det within rtol 1e-6 of the plain one.  (7, 200) leaves the last
    block one row; N = 2100 walks a row in two pieces."""
    _, y, logpi, mu, s = (_t(a) for a in _inputs(7 + K, (B, N), K))
    counts = []
    want = tm._newton_solve(y, logpi, mu, s, evaluations=counts)
    x, trips, evals = _refill_walk(y, logpi, mu, s, rows)
    assert torch.equal(x, want) and torch.equal(evals, counts[0])
    flat = counts[0].reshape(-1).tolist()
    parts = cm.warp_parts(B, N, rows)
    assert sorted(i for a, b in parts for i in range(a, b)) == list(range(B * N))
    assert trips.tolist() == [cm.part_trips(flat[a:b]) for a, b in parts]
    assert cm.warp_evaluations(counts[0], rows) == 32 * int(trips.sum())
    assert int(counts[0].sum()) <= 32 * int(trips.sum())
    lp = tmath.mix_logistic_logpdf(x, logpi, mu, s)
    _, plain_ld = tm.mix_log_cdf_inverse_reference(y, logpi, mu, s)
    close(_fixed_order_logdet(lp), plain_ld, 0.0, 1e-6)


def test_rows_per_block_fill_one_wave():
    """The headline (1024, 512) on 132 SMs of 4 blocks: 2 rows a block, 512
    blocks in one wave; a row longer than CHUNK takes a block alone."""
    assert cm.rows_per_block(1024, 512, 4 * 132) == 2
    assert cm.rows_per_block(256, 512, 4 * 132) == 1
    assert cm.rows_per_block(100000, 512, 4 * 132) == cm.CHUNK // 512
    assert cm.rows_per_block(4, 5000, 4 * 132) == 1
    parts = cm.warp_parts(1024, 512, 2)
    assert len(parts) == 512 * cm.WARPS and {b - a for a, b in parts} == {128}
    assert cm.part_trips([3] * 32 + [5]) == 8 and cm.part_trips([]) == 0
    assert cm.part_trips([4] * 64) == 8 and cm.part_trips([9] + [1] * 62) == 9


def test_cpu_tensors_take_the_plain_version():
    _, y, logpi, mu, s = (_t(a) for a in _inputs(5, (2, 128), 8))
    before = dict(cm.LAUNCHES)
    x, ld = tm.mix_log_cdf_inverse(y, logpi, mu, s)
    assert cm.LAUNCHES == before
    want = tm.mix_log_cdf_inverse_reference(y, logpi, mu, s)
    close(x, want[0], 0.0)
    close(ld, want[1], 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cm.launch(y, logpi, mu, s)
    chunks = {k: cm.component_chunks(k) for k in (1, 8, 9, 32, 33, 64)}
    assert chunks[1] == [(0, 1)] and chunks[8] == [(0, 8)] and chunks[9] == [(0, 8), (8, 9)]
    for k, walk in chunks.items():   # every component once, in k order, 8 at a time
        assert [c for a, b in walk for c in range(a, b)] == list(range(k))
        assert len(walk) == -(-k // 8) and cm.resident(k) == (k <= 8)
    with pytest.raises(NotImplementedError, match="no gradient"):
        cm.MixLogCdfInverse.backward(None, x, ld)
