"""Whole-stack fused eval kernels for the ResFlow 1-D density stack, on Hopper.

Counterpart of ``nf_tpu/ops/pallas/fused_resflow.py``; the CUDA kernel in
``nf_tpu_torch/csrc/fused_resflow.cu`` replaces its three Pallas kernels,
one template variant each:

* ``solve``    (``make_solve_kernel`` / ``call_solve``): the reverse walk
  over the n blocks of ``n x [ActNorm -> InvertibleResBlock]``, each a
  fixed point x = z - g(x), then the ActNorm inverse; for padded widths
  up to 64 (``solve_kernel``) its own kernel, ``fused_resflow_solve_kernel``
  (a warp per 8 samples, the weights through a bulk-copy ring, no block
  barrier), past that the template's variant 0;
* ``solve_ld`` (``make_solve_logdet_kernel`` / ``call_solve_logdet``): the
  same, plus every block's 'unbias' log-det series at the solved x;
* ``fwd_ld``   (``make_fwd_logdet_kernel`` / ``call_fwd_logdet``): the
  forward walk, ActNorm then x + g(x), with the same series.

g is SN-Dense(D -> F) -> LipSwish -> SN-Dense(F -> F) -> LipSwish ->
SN-Dense(F -> D).  Its Jacobian is J = W3t D2 W2t D1 W1t with the
LipSwish' masks D1, D2 at the block's input, so the series' products are
J^T w = W1 (D1 (W2 (D2 (W3 w)))) with W = Wt^T: hand-derived here and in
the kernel, from the saved pre-activations.  The series (``nf_tpu``'s
serving estimator: 4 probes, n_exact = 8, p = 0.5) is, per probe s,
sum_{k <= n_terms[s]} (-1)^(k+1) 2^max(0, k-9) / k * v_s^T (J^T)^k v_s,
and the block's log-det is its mean over the probes.

Host side, once per stack:

* ``extract_resflow_spec`` matches the chain with ``nf_tpu``'s rules;
* ``pack_resflow`` resolves the spectral-norm scaling and lays the
  weights out with ``nf_tpu``'s keys and shapes, so the two compare array
  by array; ``an_const = sum(an_s)`` is ActNorm's constant log-det;
* ``PackedResFlow`` keeps that and, for a stack on the card, the kernel's
  own layout (``kernel_weights``: one contiguous block per residual block,
  zero-padded to the kernel's width FP and dimension DP, with W2 and W2t
  split for 3xTF32 and laid out in mma fragment order).  These tilings
  cover F <= 256 and D <= 8; from F = 128 they stream the fragments
  instead of staging them.  Past either limit the wide kernel
  (``fused_resflow_wide_kernel``, F and D at run time, FFMA, 8 samples a
  block) runs the stack from ``wide_weights``' layout, its tile's vectors
  in shared memory or device scratch (``wide_plan``): every matched spec
  has a kernel (``covers``, ``kernel_path``).

The probes are arguments (``ops/estimators.py``): V (S, B, D) and the
series lengths n_terms (S,).  ``fused_resflow`` is the wrapper: for CPU
tensors it runs the plain PyTorch versions
(``fused_resflow_solve_reference``, ``..._solve_logdet_reference``,
``..._fwd_logdet_reference``); for CUDA tensors it launches the kernel or
raises, and counts the launch in ``LAUNCHES`` (and by kernel in
``launches_by_path``: 'tile', 'warp' or 'wide').

Stopping: the plain versions stop the fixed point on the whole batch, as
the chain does; the series kernels stop per block, a tile of ``SAMPLES``
samples, and the solve kernel per warp of 8.  All stop only where
max|x - prev| < ftol, so they agree within the fixed point's tolerance,
not bitwise.

Bound (H100 SXM): per sample and block one g evaluation is D F + F^2 + F D
multiply-adds (1,152 at D = 2, F = 32), and each live series term one
J^T product of the same size; at the port's probes that is 42 products
per sample and block forward, ~47 inverse (the solve's few evaluations
added), 2.5e10 flop per direction at B = 8192, n = 32: operations bound
both directions (0.4 ms with every multiply-add at the 67 TFLOP/s FFMA
rate, 0.16 ms with the F x F products on the tensor cores in 3xTF32),
far above the weights' and the data's bytes.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional

import torch

from ...bijectors.iresblock import InvertibleResBlock
from ...bijectors.norm import ActNorm
from ...core.bijector import Chain
from ...nets.core import Sequential
from ...nets.spectral import LipSwish, SpectralNormDense
from .. import estimators as est
from ..estimators import N_EXACT, N_SAMPLES, Probes, draw_unbias_probes  # noqa: F401
from . import _build

SMEM_LIMIT = 232448        # dynamic shared memory one Hopper block may use
WIDTHS = (16, 32, 64, 128, 256)  # the tiled kernels' padded hidden widths FP
DIMS = (2, 4, 8)                # and padded data dimensions DP; past them the wide kernel

# launches of each kernel variant, counted by the wrapper where it launches
LAUNCHES = {"fused_resflow_solve": 0, "fused_resflow_solve_ld": 0,
            "fused_resflow_fwd_ld": 0}
# the same launches by kernel: 'tile' (the series template, and the solve past
# SOLVE_WIDTHS), 'warp' (the solve kernel), 'wide' (past WIDTHS or DIMS)
launches_by_path: Counter = Counter()
# direction -> (kernel variant id, counter)
_VARIANTS = {"solve": (0, "fused_resflow_solve"), "inverse": (1, "fused_resflow_solve_ld"),
             "forward": (2, "fused_resflow_fwd_ld")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    launches_by_path.clear()


@dataclass(frozen=True)
class ResFlowSpec:
    n_repeats: int     # number of [ActNorm, InvertibleResBlock] pairs
    dim: int           # data dimensionality D
    filters: int       # g-MLP hidden width F
    n_iters: int       # fixed-point iteration cap
    ftol: float        # fixed-point tolerance
    estimator: str = "unbias"  # per-block log-det estimator (uniform)
    kind: str = "resflow"


# --------------------------------------------------------------------------
# structural detection
# --------------------------------------------------------------------------
def extract_resflow_spec(chain, dims) -> Optional[ResFlowSpec]:
    """Match chain.layers against alternating ActNorm / InvertibleResBlock
    with the 3-layer SN-Dense + LipSwish g, as ``nf_tpu`` does; every
    match has a kernel (``kernel_path``)."""
    if not isinstance(chain, Chain) or len(dims) != 1:
        return None
    layers = list(chain.layers)
    if len(layers) < 4 or len(layers) % 2 != 0:
        return None
    D = dims[0]
    filters = settings = None
    for i, layer in enumerate(layers):
        if i % 2 == 0:
            if not isinstance(layer, ActNorm) or layer.num_channels != D:
                return None
            continue
        if not isinstance(layer, InvertibleResBlock):
            return None
        g = layer.g_net
        if not isinstance(g, Sequential) or len(g.layers) != 5:
            return None
        d0, a0, d1, a1, d2 = g.layers
        if not (isinstance(d0, SpectralNormDense) and isinstance(d1, SpectralNormDense)
                and isinstance(d2, SpectralNormDense)
                and isinstance(a0, LipSwish) and isinstance(a1, LipSwish)):
            return None
        if d0.in_features != D or d2.out_features != D:
            return None
        if d0.out_features != d1.in_features or d1.out_features != d2.in_features \
                or d0.out_features != d1.out_features:
            return None
        if filters is None:
            filters = d0.out_features
        elif filters != d0.out_features:
            return None
        s = (layer.n_iters, layer.ftol, layer.estimator)
        if settings is None:
            settings = s
        elif settings != s:
            return None
    n_iters, ftol, estimator = settings
    return ResFlowSpec(n_repeats=len(layers) // 2, dim=D, filters=filters,
                       n_iters=int(n_iters), ftol=float(ftol), estimator=str(estimator))


# --------------------------------------------------------------------------
# host-side packing, once per stack
# --------------------------------------------------------------------------
def _stacked(tensors):
    return torch.stack([t.detach() for t in tensors])


@torch.no_grad()
def pack_resflow(chain, spec: ResFlowSpec):
    """Eval-mode effective weights stacked across blocks, ``nf_tpu``'s keys
    and shapes:
      an_s, an_b (n, D, 1)   ActNorm log-scale and bias
      w1t (n, F, D), b1 (n, F, 1), w2t (n, F, F), b2 (n, F, 1),
      w3t (n, D, F), b3 (n, D, 1)    g's (out, in) weights, spectral norm
                                     resolved
      beta (n, 2)            the two LipSwish betas
      w1 (n, D, F), w2 (n, F, F), w3 (n, F, D)   their transposes (J^T)
      an_const ()            sum of every an_s: the inverse's ActNorm
                             log-det, the forward's negated."""
    layers = chain.layers
    norms = [layers[i] for i in range(0, len(layers), 2)]
    nets = [layers[i].g_net.layers for i in range(1, len(layers), 2)]

    def weight(li):
        return _stacked([g[li].weight().T for g in nets])

    def bias(li):
        return _stacked([g[li].b for g in nets])[:, :, None]

    p = {"an_s": _stacked([l.log_scale for l in norms])[:, :, None],
         "an_b": _stacked([l.bias for l in norms])[:, :, None],
         "w1t": weight(0), "b1": bias(0), "w2t": weight(2), "b2": bias(2),
         "w3t": weight(4), "b3": bias(4),
         "beta": torch.stack([_stacked([g[1].beta[0] for g in nets]),
                              _stacked([g[3].beta[0] for g in nets])], dim=1)}
    for name in ("1", "2", "3"):
        p["w" + name] = p["w" + name + "t"].transpose(1, 2)
    p["an_const"] = torch.sum(p["an_s"])
    return p


# --------------------------------------------------------------------------
# plain PyTorch versions, (B, D) layout
# --------------------------------------------------------------------------
def _lipswish(a, beta):
    """LipSwish and its derivative at the pre-activation a."""
    s = torch.sigmoid(beta * a)
    return a * s / 1.1, (s + beta * a * s * (1.0 - s)) / 1.1


def _hidden(P, j, x):
    """g's hidden activation h2 and the LipSwish' masks d1, d2 at x."""
    h1, d1 = _lipswish(x @ P["w1t"][j].T + P["b1"][j, :, 0], P["beta"][j, 0])
    h2, d2 = _lipswish(h1 @ P["w2t"][j].T + P["b2"][j, :, 0], P["beta"][j, 1])
    return h2, d1, d2


def _g(P, j, x):
    return _hidden(P, j, x)[0] @ P["w3t"][j].T + P["b3"][j, :, 0]


def _solve(P, j, z, spec: ResFlowSpec):
    """x = z - g(x) by fixed-point iteration, stopping on the whole batch;
    returns (x, it), ``it`` the trip count as ``nf_tpu`` counts it."""
    x, prev, it = z - _g(P, j, z), z, 1
    while it < spec.n_iters and float(torch.max(torch.abs(x - prev))) >= spec.ftol:
        x, prev, it = z - _g(P, j, x), x, it + 1
    return x, it


def _coefficients(n_terms, device):
    """(cap, S): term k's weight for each probe, 0 past the probe's length."""
    n_terms = [int(n) for n in n_terms]
    table = [[est.roulette_coefficient(k, est.P, N_EXACT) if k <= nt else 0.0 for nt in n_terms]
             for k in range(1, max(n_terms) + 1)]
    return torch.tensor(table, dtype=torch.float32, device=device)


def _series(P, j, d1, d2, V, coefs):
    """The block's 'unbias' estimate at the point of d1, d2: the mean over
    the probes V (S, B, D) of their roulette series; (B,)."""
    w, ser = V, torch.zeros(V.shape[:2], dtype=torch.float32, device=V.device)
    for c in coefs:
        t = (w @ P["w3"][j].T) * d2
        t = (t @ P["w2"][j].T) * d1
        w = t @ P["w1"][j].T
        ser = ser + c[:, None] * (w * V).sum(dim=2)
    out = ser[0]
    for s in range(1, ser.shape[0]):
        out = out + ser[s]
    return out / float(ser.shape[0])


def _check_probes(probes: Probes, x: torch.Tensor):
    if probes is None:
        raise ValueError("the 'unbias' log-det needs probes (V, n_terms)")
    V, n_terms = probes
    if V.shape != (N_SAMPLES,) + tuple(x.shape) or n_terms is None \
            or tuple(n_terms.shape) != (N_SAMPLES,):
        got = None if n_terms is None else tuple(n_terms.shape)
        raise ValueError(f"probes for a {tuple(x.shape)} batch are V ({N_SAMPLES}, B, D) and "
                         f"n_terms ({N_SAMPLES},), got {tuple(V.shape)} and {got}")
    return V, n_terms


def fused_resflow_solve_reference(spec: ResFlowSpec, packed, z,
                                  trips: Optional[List[int]] = None):
    """Plain version of the ``solve`` kernel: z (B, D) -> x (B, D).  When
    ``trips`` is a list, each block's trip count is appended to it."""
    x = z.to(torch.float32)
    for j in reversed(range(spec.n_repeats)):
        x, it = _solve(packed, j, x, spec)
        if trips is not None:
            trips.append(it)
        x = x * torch.exp(packed["an_s"][j, :, 0]) + packed["an_b"][j, :, 0]
    return x


def fused_resflow_solve_logdet_reference(spec: ResFlowSpec, packed, z, probes: Probes,
                                         trips: Optional[List[int]] = None):
    """Plain version of the ``solve_ld`` kernel: z (B, D) -> (x, logdet of
    the inverse (B,)) = (x, an_const - sum_j series_j)."""
    x = z.to(torch.float32)
    V, n_terms = _check_probes(probes, x)
    coefs = _coefficients(n_terms, x.device)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for j in reversed(range(spec.n_repeats)):
        x, it = _solve(packed, j, x, spec)
        if trips is not None:
            trips.append(it)
        _, d1, d2 = _hidden(packed, j, x)
        acc = acc + _series(packed, j, d1, d2, V, coefs)
        x = x * torch.exp(packed["an_s"][j, :, 0]) + packed["an_b"][j, :, 0]
    return x, packed["an_const"] - acc


def fused_resflow_fwd_logdet_reference(spec: ResFlowSpec, packed, x, probes: Probes):
    """Plain version of the ``fwd_ld`` kernel: x (B, D) -> (z, logdet (B,))
    = (z, sum_j series_j - an_const)."""
    x = x.to(torch.float32)
    V, n_terms = _check_probes(probes, x)
    coefs = _coefficients(n_terms, x.device)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for j in range(spec.n_repeats):
        x = (x - packed["an_b"][j, :, 0]) * torch.exp(-packed["an_s"][j, :, 0])
        h2, d1, d2 = _hidden(packed, j, x)
        acc = acc + _series(packed, j, d1, d2, V, coefs)
        x = x + (h2 @ packed["w3t"][j].T + packed["b3"][j, :, 0])
    return x, acc - packed["an_const"]


# --------------------------------------------------------------------------
# the kernel's layout and its wrapper
# --------------------------------------------------------------------------
SAMPLES = 16        # samples per kernel block: two groups of 8 (one mma's n)
WARPS = 4           # warps per block: two per group
SCRATCH_STRIDE = SAMPLES + 8   # row stride of the [feature][sample] scratch


def covers(spec: ResFlowSpec) -> bool:
    """Whether a kernel takes the stack: every spec ``extract_resflow_spec``
    matches, at any F and D (the card's memory is the only ceiling)."""
    return spec.filters >= 1 and spec.dim >= 1


def kernel_path(spec: ResFlowSpec) -> str:
    """'tile' (the tiled kernels, FP and DP template sizes) up to F = 256
    and D = 8, 'wide' past either."""
    return "tile" if spec.filters <= WIDTHS[-1] and spec.dim <= DIMS[-1] else "wide"


def padded_width(filters: int) -> int:
    return min(fp for fp in WIDTHS if fp >= filters)


def padded_dim(dim: int) -> int:
    return min(dp for dp in DIMS if dp >= dim)


@dataclass(frozen=True)
class Layout:
    """Offsets (floats) inside one residual block's weight block; the
    kernel's ``Layout`` computes the same.  Zero-padded to FP and DP:
      w1t [FP][DP], b1 [FP], b2 [FP], w3t [DP][FP], b3 [DP], an_s [DP],
      an_b [DP], beta [2], padded to a multiple of 4 (``small``); then
      w2  [KS][MT][2][32][4]   W2 = w2t^T (the J^T product) in mma A-fragment
                               order, big and small parts (``fragments``)
      w2t [KS][MT][2][32][4]   w2t (g's hidden layer), the same
    with MT = FP / 16 m-tiles and KS = FP / 8 k-steps.  Up to FP = 64 the
    kernel stages the whole block in shared memory; from FP = 128
    (``streamed``) only the small tensors, and each warp streams the
    fragments it multiplies, ``chunk_tiles`` m-tiles of one k-step at a
    time, through a two-slot ring of its own."""
    fp: int
    dp: int

    @property
    def w1t(self) -> int:
        return 0

    @property
    def b1(self) -> int:
        return self.fp * self.dp

    @property
    def b2(self) -> int:
        return self.b1 + self.fp

    @property
    def w3t(self) -> int:
        return self.b2 + self.fp

    @property
    def b3(self) -> int:
        return self.w3t + self.dp * self.fp

    @property
    def an_s(self) -> int:
        return self.b3 + self.dp

    @property
    def an_b(self) -> int:
        return self.an_s + self.dp

    @property
    def beta(self) -> int:
        return self.an_b + self.dp

    @property
    def small(self) -> int:
        return (self.beta + 2 + 3) // 4 * 4

    @property
    def w2(self) -> int:
        return self.small

    @property
    def w2t(self) -> int:
        return self.w2 + 2 * self.fp * self.fp

    @property
    def size(self) -> int:
        return self.w2t + 2 * self.fp * self.fp

    @property
    def streamed(self) -> bool:
        return self.fp >= 128

    @property
    def staged(self) -> int:
        return self.small if self.streamed else self.size

    @property
    def chunk_tiles(self) -> int:
        return min(self.fp // 16, 8)

    @property
    def ring(self) -> int:
        """Floats of one warp's fragment ring (two slots)."""
        return 2 * self.chunk_tiles * 256 if self.streamed else 0


def smem_bytes(fp: int, dp: int) -> int:
    """Dynamic shared memory of one block; the kernel computes the same:
    two staged weight blocks (double-buffered), the warps' fragment rings,
    h1 / d1 / d2 for the tile's samples, the series per (probe, sample) and
    the two partial g per (sample, dimension)."""
    lay = Layout(fp, dp)
    return 4 * (2 * lay.staged + WARPS * lay.ring + 3 * fp * SCRATCH_STRIDE
                + N_SAMPLES * SAMPLES + 2 * SAMPLES * dp)


def fragment_index(fp: int):
    """(rows, cols), each (KS, MT, 32, 4): the matrix entry that lane l of
    an m16n8k8 TF32 A fragment holds in register r, for k-step ks and
    m-tile mt: r = 0 (16 mt + g, 8 ks + t), 1 (+ 8, same), 2 (same, + 4),
    3 (+ 8, + 4), with g = l // 4 and t = l % 4."""
    ks = torch.arange(fp // 8)[:, None, None, None]
    mt = torch.arange(fp // 16)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    r = torch.arange(4)[None, None, None, :]
    rows = 16 * mt + lane // 4 + 8 * (r % 2)
    cols = 8 * ks + lane % 4 + 4 * (r // 2)
    shape = (fp // 8, fp // 16, 32, 4)
    return rows.expand(shape), cols.expand(shape)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 on its bits (13 low mantissa bits cleared, to
    nearest, ties away from zero), as csrc/attention.cu rounds."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def fragments(mat: torch.Tensor) -> torch.Tensor:
    """(n, FP, FP) matrices (rows: outputs) -> (n, KS, MT, 2, 32, 4): the
    kernel's A fragments of each, big = the TF32 rounding, small = x - big
    (exact in f32)."""
    rows, cols = fragment_index(mat.shape[-1])
    a = mat[:, rows, cols]
    big = tf32_round(a.contiguous())
    return torch.stack([big, a - big], dim=3)


def probe_pairs(n_terms) -> List[int]:
    """The probes of the kernel's two warps per group, [a, d, b, c] with
    a >= b >= c >= d their series lengths (ties by probe index): warp 0
    runs a and d, warp 1 b and c, so a block runs max(a + d, b + c)
    8-column terms in its busier warp, against a mean of (a+b+c+d) / 2."""
    nt = [int(n) for n in n_terms]
    a, b, c, d = sorted(range(len(nt)), key=lambda s: (-nt[s], s))
    return [a, d, b, c]


@dataclass(frozen=True)
class KernelWeights:
    fp: int
    dp: int
    w: torch.Tensor    # (n, Layout.size)


@torch.no_grad()
def kernel_weights(spec: ResFlowSpec, packed) -> KernelWeights:
    n, D, F = spec.n_repeats, spec.dim, spec.filters
    fp, dp = padded_width(F), padded_dim(D)
    lay = Layout(fp, dp)
    dev = packed["w2t"].device
    w = torch.zeros(n, lay.size, dtype=torch.float32, device=dev)

    def block(off, rows, cols):
        return w[:, off:off + rows * cols].view(n, rows, cols)

    block(lay.w1t, fp, dp)[:, :F, :D] = packed["w1t"]
    block(lay.b1, 1, fp)[:, 0, :F] = packed["b1"][:, :, 0]
    block(lay.b2, 1, fp)[:, 0, :F] = packed["b2"][:, :, 0]
    block(lay.w3t, dp, fp)[:, :D, :F] = packed["w3t"]
    block(lay.b3, 1, dp)[:, 0, :D] = packed["b3"][:, :, 0]
    block(lay.an_s, 1, dp)[:, 0, :D] = packed["an_s"][:, :, 0]
    block(lay.an_b, 1, dp)[:, 0, :D] = packed["an_b"][:, :, 0]
    block(lay.beta, 1, 2)[:, 0] = packed["beta"]
    w2t = torch.zeros(n, fp, fp, dtype=torch.float32, device=dev)
    w2t[:, :F, :F] = packed["w2t"]
    w[:, lay.w2:lay.w2t] = fragments(w2t.transpose(1, 2)).reshape(n, -1)
    w[:, lay.w2t:lay.size] = fragments(w2t).reshape(n, -1)
    return KernelWeights(fp=fp, dp=dp, w=w)


# the wide kernel (``fused_resflow_wide_kernel``): F and D at run time
WIDE_SAMPLES = 8      # samples per block
WIDE_THREADS = 256    # threads per block
WIDE_RED = WIDE_THREADS * WIDE_SAMPLES   # the reduction buffer's floats


@dataclass(frozen=True)
class WideLayout:
    """Offsets (floats) inside one residual block's wide weight block; the
    kernel's ``WideLayout`` computes the same.  Each product's matrix
    input-major, unpadded: g1 [D][F] (W1t^T), b1 [F], g2 [F][F] (W2t^T),
    b2 [F], g3 [F][D] (W3t^T), b3 [D], an_s [D], an_b [D], beta [2], then
    J^T's j3 [D][F] (W3t), j2 [F][F] (W2t), j1 [F][D] (W1t)."""
    f: int
    d: int

    def offsets(self):
        f, d = self.f, self.d
        sizes = (("g1", d * f), ("b1", f), ("g2", f * f), ("b2", f), ("g3", f * d),
                 ("b3", d), ("an_s", d), ("an_b", d), ("beta", 2), ("j3", d * f),
                 ("j2", f * f), ("j1", f * d))
        out, at = {}, 0
        for name, n in sizes:
            out[name] = at
            at += n
        out["size"] = at
        return out

    @property
    def size(self) -> int:
        return self.offsets()["size"]


def wide_scratch_floats(f: int, d: int) -> int:
    """Floats of one wide block's vectors: x, z, g, a probe and its J^T
    iterate (D each), h1, d1, h2, d2 (F each) per sample, the four series
    and the log-det per sample."""
    return WIDE_SAMPLES * (5 * d + 4 * f + N_SAMPLES + 1)


def wide_plan(f: int, d: int):
    """(vectors in shared memory?, dynamic shared bytes of one block): the
    vectors go beside the reduction buffer while the block fits
    ``SMEM_LIMIT``, else to device scratch and the block holds the buffer
    alone."""
    shared = 4 * (WIDE_RED + wide_scratch_floats(f, d))
    return (True, shared) if shared <= SMEM_LIMIT else (False, 4 * WIDE_RED)


@dataclass(frozen=True)
class WideWeights:
    f: int
    d: int
    w: torch.Tensor    # (n, WideLayout.size)
    in_shared: bool    # wide_plan's choice


@torch.no_grad()
def wide_weights(spec: ResFlowSpec, packed) -> WideWeights:
    n, D, F = spec.n_repeats, spec.dim, spec.filters
    off = WideLayout(F, D).offsets()
    w = torch.empty(n, off["size"], dtype=torch.float32, device=packed["w2t"].device)
    parts = {"g1": packed["w1"], "b1": packed["b1"][:, :, 0], "g2": packed["w2"],
             "b2": packed["b2"][:, :, 0], "g3": packed["w3"], "b3": packed["b3"][:, :, 0],
             "an_s": packed["an_s"][:, :, 0], "an_b": packed["an_b"][:, :, 0],
             "beta": packed["beta"], "j3": packed["w3t"], "j2": packed["w2t"],
             "j1": packed["w1t"]}
    for name, t in parts.items():
        w[:, off[name]:off[name] + t[0].numel()] = t.reshape(n, -1)
    return WideWeights(f=F, d=D, w=w, in_shared=wide_plan(F, D)[0])


class PackedResFlow:
    """One stack's packed weights, built once: ``nf_tpu``'s layout for the
    plain versions and, for a stack on the card, its kernel's layout
    (``kernel_weights`` up to F = 256 and D = 8, ``wide_weights`` past)."""

    def __init__(self, spec: ResFlowSpec, packed):
        self.spec = spec
        self.packed = packed
        self.device = packed["an_const"].device
        self.kernel = self.an_const = None
        if self.device.type != "cpu":
            self.kernel = (kernel_weights if kernel_path(spec) == "tile"
                           else wide_weights)(spec, packed)
            self.an_const = float(packed["an_const"])


def _kernel_fn():
    fn = _build.load("fused_resflow").nf_fused_resflow
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 5 + [ctypes.POINTER(i)] * 2 + [i] * 7 + [f, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(fp: int, dp: int, direction: str) -> int:
    """Blocks of the kernel variant that one SM of the current card holds
    at once (the CUDA occupancy API, with the kernel's threads and shared
    memory).  A batch of B launches ceil(B / SAMPLES) blocks.  The solve
    has this variant only past SOLVE_WIDTHS (``solve_blocks_per_sm``)."""
    variant, _ = _variant(direction)
    fn = _build.load("fused_resflow").nf_fused_resflow_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(fp, dp, variant, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_resflow: occupancy query failed: CUDA error {err}")
    return out.value


# the solve kernel (``fused_resflow_solve_kernel``): a warp per 8 samples,
# the weights through a ring of residual-block slots filled by a producer
# warp; for the padded widths SOLVE_WIDTHS.  Wider stacks run variant 0.
SOLVE_WIDTHS = (16, 32, 64)
SOLVE_WARPS = 4     # consumer warps per block, and one producer warp
SOLVE_BARRIER_BYTES = 128


def solve_kernel(fp: int) -> str:
    """Which kernel runs the solve at padded width FP: 'warp' (the
    warp-per-8-samples kernel) or 'tile' (variant 0, 16-sample tiles)."""
    return "warp" if fp in SOLVE_WIDTHS else "tile"


def solve_slots(fp: int) -> int:
    """Residual blocks in flight in the solve kernel's ring."""
    return 4 if fp <= 32 else 2


def solve_slot_floats(fp: int, dp: int) -> int:
    """One ring slot: the block's small tensors, then its W2t fragments."""
    return Layout(fp, dp).small + 2 * fp * fp


def solve_smem_bytes(fp: int, dp: int) -> int:
    return SOLVE_BARRIER_BYTES + 4 * solve_slots(fp) * solve_slot_floats(fp, dp)


def solve_blocks(B: int) -> int:
    return -(-B // (8 * SOLVE_WARPS))


def solve_weight_bytes_to_sm(kw: KernelWeights, n: int, B: int) -> int:
    """Bytes the solve kernel's producer warps copy from L2 into shared
    memory per call: every block reads every residual block's slot."""
    return solve_blocks(B) * n * 4 * solve_slot_floats(kw.fp, kw.dp)


def solve_blocks_per_sm(fp: int, dp: int) -> int:
    """Blocks of the solve kernel that one SM of the current card holds at
    once (the CUDA occupancy API)."""
    fn = _build.load("fused_resflow").nf_fused_resflow_solve_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(fp, dp, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_resflow: occupancy query failed: CUDA error {err}")
    return out.value


def _solve_fn():
    fn = _build.load("fused_resflow").nf_fused_resflow_solve
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [i] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _wide_fn():
    fn = _build.load("fused_resflow").nf_fused_resflow_wide
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 5 + [ctypes.POINTER(i), p] + [i] * 5 + [f, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def launch(stack: PackedResFlow, x: torch.Tensor, direction: str,
           probes: Optional[Probes] = None):
    """Launch the CUDA kernel on ``x`` (B, D).  ``direction`` 'forward'
    (fwd_ld) or 'inverse' (solve_ld) returns (y, logdet (B,)) and needs
    ``probes``; 'solve' returns x, from the kernel ``solve_kernel`` picks
    (the wide kernel past WIDTHS or DIMS)."""
    variant, counter = _variant(direction)
    kw, spec = stack.kernel, stack.spec
    if not x.is_cuda:
        raise ValueError(f"fused_resflow kernel needs a CUDA tensor, got {x.device}")
    if kw is None or kw.w.device != x.device:
        raise ValueError(f"fused_resflow: weights on {stack.device}, x on {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != spec.dim \
            or not x.is_contiguous():
        raise ValueError(f"fused_resflow kernel takes a contiguous float32 (B, {spec.dim}) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    logdet = direction != "solve"
    n_terms = [1] * N_SAMPLES
    V = None
    if logdet:
        V, n_terms = _check_probes(probes, x)
        n_terms = [int(n) for n in n_terms]
        if V.device != x.device or V.dtype != torch.float32 or not V.is_contiguous():
            raise ValueError("fused_resflow: probes must be a contiguous float32 tensor "
                             "on the device of x")
        if not all(1 <= nt <= N_EXACT + 32 for nt in n_terms):
            raise ValueError(f"fused_resflow: series lengths {n_terms} out of range")
    y = torch.empty_like(x)
    ld = torch.empty(B, dtype=torch.float32, device=x.device) if logdet else None
    if B == 0:
        return (y, ld) if logdet else y
    sign = 1.0 if direction == "forward" else -1.0
    nt = (ctypes.c_int * N_SAMPLES)(*n_terms)
    if isinstance(kw, WideWeights):
        scratch = None if kw.in_shared else torch.empty(
            -(-B // WIDE_SAMPLES) * wide_scratch_floats(kw.f, kw.d), dtype=torch.float32,
            device=x.device)
        with torch.cuda.device(x.device):
            err = _wide_fn()(x.data_ptr(), y.data_ptr(), ld.data_ptr() if logdet else None,
                             kw.w.data_ptr(), V.data_ptr() if logdet else None, nt,
                             None if scratch is None else scratch.data_ptr(), B,
                             spec.n_repeats, spec.dim, spec.filters, spec.n_iters, spec.ftol,
                             variant, sign, -sign * stack.an_const,
                             torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_resflow wide {direction} kernel failed to launch: "
                               f"CUDA error {err}")
        LAUNCHES[counter] += 1
        launches_by_path["wide"] += 1
        return (y, ld) if logdet else y
    if direction == "solve" and solve_kernel(kw.fp) == "warp":
        with torch.cuda.device(x.device):
            err = _solve_fn()(x.data_ptr(), y.data_ptr(), kw.w.data_ptr(), B, spec.n_repeats,
                              spec.dim, spec.filters, kw.fp, kw.dp, spec.n_iters, spec.ftol,
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_resflow solve kernel failed to launch: CUDA error {err}")
        LAUNCHES[counter] += 1
        launches_by_path["warp"] += 1
        return y
    pairs = (ctypes.c_int * N_SAMPLES)(*probe_pairs(n_terms))
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), ld.data_ptr() if logdet else None,
                 kw.w.data_ptr(), V.data_ptr() if logdet else None, nt, pairs,
                 B, spec.n_repeats, spec.dim, spec.filters, kw.fp, kw.dp, spec.n_iters,
                 spec.ftol, variant, sign, -sign * stack.an_const,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_resflow {direction} kernel failed to launch: "
                           f"CUDA error {err}")
    LAUNCHES[counter] += 1
    launches_by_path["tile"] += 1
    return (y, ld) if logdet else y


def _variant(direction: str):
    if direction not in _VARIANTS:
        raise ValueError("direction must be 'forward', 'inverse' or 'solve', "
                         f"got {direction!r}")
    return _VARIANTS[direction]


def fused_resflow(stack: PackedResFlow, x: torch.Tensor, direction: str,
                  probes: Optional[Probes] = None):
    """Eval-mode walk of the whole stack: 'forward' -> (z, logdet),
    'inverse' -> (x, logdet of the inverse), both with the 'unbias' series
    over ``probes``; 'solve' -> x alone.

    CPU tensors take the plain versions; any other tensor launches the
    kernel or raises."""
    _variant(direction)
    if x.device.type != "cpu":
        return launch(stack, x, direction, probes)
    spec, packed = stack.spec, stack.packed
    if direction == "forward":
        return fused_resflow_fwd_logdet_reference(spec, packed, x, probes)
    if direction == "inverse":
        return fused_resflow_solve_logdet_reference(spec, packed, x, probes)
    return fused_resflow_solve_reference(spec, packed, x)
