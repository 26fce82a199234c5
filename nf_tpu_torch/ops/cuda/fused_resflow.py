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
  (``csrc/fused_resflow_wide.cu``, F and D at run time) runs the stack
  from ``wide_weights``' layout: thread block clusters of 1-8 members,
  member m holding rows [m F / C, ...) of W2t in shared memory for the
  residual block's whole walk (read from L2 past the F whose slabs no
  cluster holds), the D-wide partials crossing members through
  distributed shared memory; every product J w and g on the same three
  matrices, W2t's on the tensor cores in 3xTF32; the four probes side by
  side; ``wide_plan`` picks the cluster, the samples a cluster and what is
  resident.  Every matched spec has a kernel (``covers``, ``kernel_path``).

The probes are arguments (``ops/estimators.py``): V (S, B, D) and the
series lengths n_terms (S,).  ``fused_resflow`` is the wrapper: for CPU
tensors it runs the plain PyTorch versions
(``fused_resflow_solve_reference``, ``..._solve_logdet_reference``,
``..._fwd_logdet_reference``); for CUDA tensors it launches the kernel or
raises, and counts the launch in ``LAUNCHES``; each launch is the span
``launch.<LAUNCHES key>.<kernel>``, the kernel 'tile', 'warp' or 'wide'.

Stopping: the plain versions stop the fixed point on the whole batch, as
the chain does; the series kernels stop per block, a tile of ``SAMPLES``
samples, the solve kernel per warp of 8 and the wide kernel per cluster
(``WidePlan.samples``).  All stop only where max|x - prev| < ftol, so they
agree within the fixed point's tolerance, not bitwise.

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
import dataclasses
import functools
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
from ...utils.tracing import span
from . import _build

SMEM_LIMIT = 232448        # dynamic shared memory one Hopper block may use
WIDTHS = (16, 32, 64, 128, 256)  # the tiled kernels' padded hidden widths FP
DIMS = (2, 4, 8)                # and padded data dimensions DP; past them the wide kernel

# launches of each kernel variant, counted by the wrapper where it launches
LAUNCHES = {"fused_resflow_solve": 0, "fused_resflow_solve_ld": 0,
            "fused_resflow_fwd_ld": 0}
# direction -> (kernel variant id, counter)
_VARIANTS = {"solve": (0, "fused_resflow_solve"), "inverse": (1, "fused_resflow_solve_ld"),
             "forward": (2, "fused_resflow_fwd_ld")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# the wide kernel (``csrc/fused_resflow_wide.cu``): F and D at run time,
# thread block clusters of CLUSTER_SIZES members, each S samples a cluster
WIDE_WARPS = 16         # warps per block (one cluster member)
CLUSTER_SIZES = (1, 2, 4, 8)  # the kernel's; the planner's own choice is 1 or 2
# clusters the card holds at once, one block an SM (cudaOccupancyMaxActiveClusters
# at the wide kernel's shared memory, resflow_wide_probe.py occupancy: NVIDIA
# H100 80GB HBM3, 700.00 W)
ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
MAX_SAMPLES = 128       # samples a cluster, at most
STREAMED_SAMPLES = 16384  # ... where W2t is read from L2: this over F, 16 to 32
SCRATCH_SAMPLES = 32    # ... where the vectors are in device scratch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _r4(x: int) -> int:
    return (x + 3) // 4 * 4


def wide_geometry(F: int, D: int, C: int, S: int, Nc: int, Kc: int, w2_res: bool,
                  w1_res: bool, w3_res: bool, vec_smem: bool, part_smem: bool) -> dict:
    """Sizes and offsets (floats) of the wide kernel's weight block, shared
    memory and device scratch; the kernel's ``WideGeom`` computes the same.
    Weight block (``wide_weights``): b1 [FP], b2 [FP], b3, an_s, an_b [DP16],
    beta [2] (to a multiple of 4), W1t [FP][D] row-major, then W2t (FP x FP)
    and W3t (DP16 x FP) in A-fragment order (``wide_fragments``).  Shared:
    an mbarrier (4 floats), the resident weights (W2t slab Fs x FP, W1t,
    W3t's Fs columns), the partials [2][D][4 S] and the vectors where they
    are in shared memory; scratch (per block) the rest."""
    FP = _round_up(F, 16 * C)
    Fs, DP16 = FP // C, _round_up(D, 16)
    cols = N_SAMPLES * S
    nbuf = 2 if Kc < FP else 1
    g = {"FP": FP, "Fs": Fs, "DP16": DP16, "cols": cols, "nbuf": nbuf}
    at = 0
    for name, n in (("b1", FP), ("b2", FP), ("b3", DP16), ("an_s", DP16), ("an_b", DP16),
                    ("beta", 2)):
        g["o_" + name] = at
        at += n
    at = _r4(at)
    for name, n in (("w1", _r4(FP * D)), ("w2", FP * FP), ("w3", DP16 * FP)):
        g["o_" + name] = at
        at += n
    g["size"] = at
    smem, scratch = 4, 0
    for name, n, res in (("w2", Fs * FP, w2_res), ("w1", _r4(FP * D), w1_res),
                         ("w3", DP16 * Fs, w3_res)):
        g["s_" + name] = smem
        smem += n if res else 0
    g["staged"] = smem - 4
    part = _r4(2 * D * cols)
    if part_smem:
        g["part_at"], smem = smem, smem + part
    else:
        g["part_at"], scratch = scratch, scratch + part
    at = 0
    for name, n in (("X", D * S), ("Z", D * S), ("G", D * S), ("W", D * cols),
                    ("V", D * cols), ("d1", FP * S), ("d2", Fs * S), ("a", nbuf * Kc * Nc),
                    ("c", Fs * Nc), ("ser", N_SAMPLES * S), ("acc", S)):
        g["v_" + name] = at
        at += _r4(n)
    g["vec_floats"] = at
    if vec_smem:
        g["vec_at"], smem = smem, smem + at
    else:
        g["vec_at"], scratch = scratch, scratch + at
    g["smem_floats"], g["scratch_floats"] = smem, scratch
    return g


@dataclass(frozen=True)
class WidePlan:
    """One launch of the wide kernel: clusters of ``cluster`` blocks, each
    ``samples`` samples; stage A in k-chunks of ``kchunk`` rows, columns in
    chunks of ``chunk``; which weights are staged into shared memory
    (``w2_res``: member m's rows of W2t, the slab), whether the vectors and
    the partials are in shared memory or device scratch."""
    f: int
    d: int
    cluster: int
    samples: int
    chunk: int
    kchunk: int
    w2_res: bool
    w1_res: bool
    w3_res: bool
    vec_smem: bool
    part_smem: bool

    @functools.cached_property
    def _geometry(self) -> dict:
        return wide_geometry(self.f, self.d, self.cluster, self.samples, self.chunk,
                             self.kchunk, self.w2_res, self.w1_res, self.w3_res,
                             self.vec_smem, self.part_smem)

    def geometry(self) -> dict:
        """``wide_geometry`` of the plan, computed once a plan (read only)."""
        return self._geometry

    @property
    def smem_bytes(self) -> int:
        return 4 * self._geometry["smem_floats"]

    @property
    def scratch_floats(self) -> int:
        return self._geometry["scratch_floats"]

    @property
    def residency(self) -> str:
        """'one block' (C = 1, W2t resident), 'cluster' (its slabs
        resident), 'streamed' (read from L2 for every product)."""
        if not self.w2_res:
            return "streamed"
        return "one block" if self.cluster == 1 else "cluster"

    def clusters(self, B: int) -> int:
        return -(-B // self.samples)

    def args(self) -> List[int]:
        """The kernel's plan array: C, S, Nc, Kc and the five flags."""
        return [self.cluster, self.samples, self.chunk, self.kchunk, int(self.w2_res),
                int(self.w1_res), int(self.w3_res), int(self.vec_smem), int(self.part_smem)]

    @functools.cached_property
    def c_args(self):
        """``args`` as the C int array the launch passes, built once a plan."""
        return (ctypes.c_int * 9)(*self.args())


def _fits(g: dict) -> bool:
    return 4 * g["smem_floats"] <= SMEM_LIMIT


def _least(F: int, D: int, C: int, w2_res: bool, vec_smem: bool) -> dict:
    """The geometry of the least plan: 8 samples, chunks of 32, W2t's slab
    staged with W1t and W3t (``w2_res``) or nothing staged, the partials
    in shared memory where the vectors are or the cluster exchanges them."""
    return wide_geometry(F, D, C, 8, 32, 16, w2_res, w2_res, w2_res, vec_smem,
                         vec_smem or C > 1)


def wide_cluster(F: int, D: int) -> int:
    """The cluster size of a (D, F) stack (it fixes the weights' padding):
    1 up to F = 256, 2 past it where two members' partials fit, else 1.
    Measured (resflow_wide_probe.py clusters; NVIDIA H100 80GB HBM3,
    700.00 W): every member runs
    stage A over all F rows and a cluster of C members holds its samples
    on C SMs, so 8 members holding W2t's slabs resident ran (2, 512) at
    B = 1,000 2.3x slower than 2 members reading theirs from L2 (the
    slabs' 3.1 GB a call at 2.2 TB/s), and (63, 256) 2x slower on 2
    members than on 1."""
    if F > 256 and _fits(_least(F, D, 2, False, False)):
        return 2
    return 1


@functools.lru_cache(maxsize=None)
def wide_plan(F: int, D: int, B: int, cluster: Optional[int] = None,
              samples: Optional[int] = None) -> WidePlan:
    """The launch plan of a (D, F) stack at batch B.  W2t's slabs staged
    where they fit beside the vectors; the vectors in shared memory before
    W2t's slabs (the generic path that either leaves out is the slower),
    device scratch last (SCRATCH_SAMPLES).  Samples a cluster: as many as
    put the batch on the card in one wave (ACTIVE_CLUSTERS), at most
    MAX_SAMPLES (with W2t read from L2 at most STREAMED_SAMPLES / F, 16 to
    32: the best of 8-64 at (2, 512), (2, 1,024) and (63, 256), B = 8,192,
    on an NVIDIA H100 80GB HBM3 at 700.00 W), fewer where shared memory
    runs out.  First with stage A's k-chunks of at
    least 64 rows (or all F) and column chunks that, split over k, give
    every warp work (or hold all 4 S columns), then with any; the widest
    column chunks first (each chunk reads W2t once), then the longest
    k-chunks; W1t and W3t staged (they are read at every product) before
    more samples.
    ``cluster`` and ``samples`` override (the planner's probe,
    resflow_wide_probe.py clusters): ``wide_cluster`` picks 1 or 2 members,
    so clusters of 4 and 8 are reached only through ``cluster``."""
    C = cluster or wide_cluster(F, D)
    FP = _round_up(F, 16 * C)
    kcs = [FP] + [k for k in (1024, 512, 256, 128, 64, 32, 16) if k < FP]
    mts = FP // C // 16
    fill = max(8, _round_up(-(-B // ACTIVE_CLUSTERS[C]), 8))
    for w2, vec_smem in ((True, True), (False, True), (True, False), (False, False)):
        if not _fits(_least(F, D, C, w2, vec_smem)):
            continue
        part_smem = vec_smem or C > 1
        cap = MAX_SAMPLES if w2 else max(16, min(32, STREAMED_SAMPLES // F // 8 * 8))
        top = samples or min(fill, cap if vec_smem else SCRATCH_SAMPLES)
        for strict in (True, False):
            # a resident slab comes with W1t and W3t staged (the kernel's
            # instance that reads all three from shared memory)
            for w1, w3 in ((True, True),) if w2 else ((True, True), (True, False),
                                                       (False, True), (False, False)):
                for S in ([samples] if samples else range(top, 7, -8)):
                    ncs = [n for n in sorted({4 * S, 256, 128, 64, 32}, reverse=True)
                           if n <= 4 * S and (w2 or n % 64 == 0 or n == 32)]
                    for Nc in ncs:
                        for Kc in kcs:
                            nw = 8 if not w2 and Nc >= 64 else 4
                            units = mts * -(-Nc // (8 * nw))
                            if units > WIDE_WARPS and Nc > 8 * nw:
                                continue
                            full = units * 4 >= WIDE_WARPS or Nc == 4 * S
                            if strict and (Kc < min(FP, 64) or not full):
                                continue
                            plan = WidePlan(F, D, C, S, Nc, Kc, w2, w1, w3, vec_smem, part_smem)
                            if _fits(plan.geometry()):
                                return plan
    raise ValueError(f"fused_resflow: no wide plan for D={D} F={F} C={C} S={samples}")


def series_order(n_terms) -> List[int]:
    """The probes by series length, longest first, ties by index: the wide
    kernel's columns q S + s are the q-th of these, so the live ones are a
    prefix; its WideParams::order."""
    nt = [int(n) for n in n_terms]
    return sorted(range(len(nt)), key=lambda s: (-nt[s], s))


def wide_fragments(mat: torch.Tensor, k_major: bool) -> torch.Tensor:
    """(n, M, K) matrices, M and K multiples of 16 and 8 -> (n, M K): the
    wide kernel's A fragments in f32 (lane l, register r of m-tile mt and
    k-step ks, as ``fragment_index`` places them), m-tile major
    [M/16][K/8][32][4], or k-step major [K/8][M/16][32][4]."""
    n, M, K = mat.shape
    mt = torch.arange(M // 16)[:, None, None, None]
    ks = torch.arange(K // 8)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    r = torch.arange(4)[None, None, None, :]
    rows = (16 * mt + lane // 4 + 8 * (r % 2)).expand(M // 16, K // 8, 32, 4)
    cols = (8 * ks + lane % 4 + 4 * (r // 2)).expand(M // 16, K // 8, 32, 4)
    frag = mat[:, rows, cols]
    if k_major:
        frag = frag.transpose(1, 2)
    return frag.reshape(n, -1)


@dataclass(frozen=True)
class WideWeights:
    f: int
    d: int
    cluster: int       # wide_cluster's: the padding FP = F rounded up to 16 C
    w: torch.Tensor    # (n, wide_geometry()["size"])


@torch.no_grad()
def wide_weights(spec: ResFlowSpec, packed, cluster: Optional[int] = None) -> WideWeights:
    n, D, F = spec.n_repeats, spec.dim, spec.filters
    C = cluster or wide_cluster(F, D)
    g = wide_geometry(F, D, C, 8, 32, 16, False, False, False, False, False)
    FP, DP16 = g["FP"], g["DP16"]
    dev = packed["w2t"].device
    w = torch.zeros(n, g["size"], dtype=torch.float32, device=dev)
    for name, t in (("b1", packed["b1"][:, :, 0]), ("b2", packed["b2"][:, :, 0]),
                    ("b3", packed["b3"][:, :, 0]), ("an_s", packed["an_s"][:, :, 0]),
                    ("an_b", packed["an_b"][:, :, 0]), ("beta", packed["beta"])):
        w[:, g["o_" + name]:g["o_" + name] + t.shape[1]] = t

    def padded(t, rows, cols):
        out = torch.zeros(n, rows, cols, dtype=torch.float32, device=dev)
        out[:, :t.shape[1], :t.shape[2]] = t
        return out

    w[:, g["o_w1"]:g["o_w1"] + FP * D] = padded(packed["w1t"], FP, D).reshape(n, -1)
    w[:, g["o_w2"]:g["o_w3"]] = wide_fragments(padded(packed["w2t"], FP, FP), False)
    w[:, g["o_w3"]:g["size"]] = wide_fragments(padded(packed["w3t"], DP16, FP), True)
    return WideWeights(f=F, d=D, cluster=C, w=w)


def wide_weight_bytes(plan: WidePlan, n: int, B: int, chains) -> int:
    """Bytes of weights a launch reads from L2 into the SMs: each member's
    staged weights once a residual block, and each product's matrices that
    are not staged once for every column chunk that multiplies by them
    (W1t once more for every further group of the warps' items).
    ``chains`` lists (columns, with stage C) of the product chains one
    cluster runs (``wide_chains``)."""
    g = plan.geometry()
    C, FP, Fs = plan.cluster, g["FP"], g["Fs"]
    members = plan.clusters(B) * C
    mts = Fs // 16
    per_cluster = C * n * g["staged"]
    for cols, stage_c in chains:
        for c0 in range(0, cols, plan.chunk):
            nt = min(plan.chunk, cols - c0) // 8
            groups = -(-mts * -(-nt // 4) // WIDE_WARPS)
            per = 0 if plan.w2_res else Fs * FP
            per += 0 if plan.w1_res else groups * FP * plan.d
            per += 0 if plan.w3_res or not stage_c else g["DP16"] * Fs
            per_cluster += C * per
    return 4 * plan.clusters(B) * per_cluster


def wide_chains(plan: WidePlan, direction: str, n: int, n_terms=None, trips=None):
    """The product chains one cluster runs in a call, (columns, with stage
    C), for ``wide_weight_bytes``: per residual block its g evaluations (the
    forward 1, the solve ``trips[j]`` in walk order; the solve_ld's mask
    evaluation one more, without stage C) and, with the series, a term of
    L S columns while L probes last."""
    S = plan.samples
    out = []
    for j in range(n):
        evals = 1 if direction == "forward" else int(trips[j])
        out += [(S, True)] * evals
        if direction == "inverse":
            out.append((S, False))
        if direction != "solve":
            nt = sorted((int(t) for t in n_terms), reverse=True)
            out += [(S * sum(t >= k for t in nt), True) for k in range(1, nt[0] + 1)]
    return out


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
    fn = _build.load("fused_resflow_wide").nf_fused_resflow_wide
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 5 + [ctypes.POINTER(i), p] + [i] * 5 + [f, i, f, f]
                       + [ctypes.POINTER(i), p])
        fn.restype = ctypes.c_int
    return fn


def wide_active_clusters(plan: WidePlan, direction: str = "forward") -> int:
    """Clusters of ``plan``'s launch that the current card holds at once
    (cudaOccupancyMaxActiveClusters); resflow_wide_probe.py records them
    in ACTIVE_CLUSTERS.  Not called on the kernel's path."""
    variant, _ = _variant(direction)
    fn = _build.load("fused_resflow_wide").nf_fused_resflow_wide_active_clusters
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(plan.d, plan.f, variant, (ctypes.c_int * 9)(*plan.args()), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_resflow wide: occupancy query failed: CUDA error {err}")
    return out.value


def launch_wide(stack: PackedResFlow, x: torch.Tensor, direction: str, probes: Optional[Probes],
                plan: Optional[WidePlan] = None, n_terms: Optional[List[int]] = None):
    """The wide kernel's launch on ``x`` (B, D), checked as ``launch``
    checks it, at ``wide_plan``'s plan for the batch unless ``plan`` is
    given (of the weights' cluster size); counts the launch.  ``n_terms``:
    the probes' series lengths as ints, where the caller has them."""
    with span(f"launch.{_variant(direction)[1]}.wide"):
        return _launch_wide(stack, x, direction, probes, plan, n_terms)


def _launch_wide(stack, x, direction, probes, plan, n_terms):
    spec, kw = stack.spec, stack.kernel
    B = x.shape[0]
    variant, counter = _variant(direction)
    logdet = direction != "solve"
    y = torch.empty_like(x)
    ld = torch.empty(B, dtype=torch.float32, device=x.device) if logdet else None
    if B == 0:
        return (y, ld) if logdet else y
    plan = plan or wide_plan(spec.filters, spec.dim, B, kw.cluster)
    if plan.cluster != kw.cluster or (plan.f, plan.d) != (spec.filters, spec.dim):
        raise ValueError(f"fused_resflow wide: plan {plan} for weights of cluster "
                         f"{kw.cluster}, D={spec.dim}, F={spec.filters}")
    if logdet:
        V, n_terms = probes[0], n_terms or [int(n) for n in probes[1]]
    else:
        V, n_terms = None, [1] * N_SAMPLES
    scratch = None
    if plan.scratch_floats:
        scratch = torch.empty(plan.clusters(B) * plan.cluster * plan.scratch_floats,
                              dtype=torch.float32, device=x.device)
    sign = 1.0 if direction == "forward" else -1.0
    with torch.cuda.device(x.device):
        err = _wide_fn()(x.data_ptr(), y.data_ptr(), ld.data_ptr() if logdet else None,
                         kw.w.data_ptr(), V.data_ptr() if logdet else None,
                         (ctypes.c_int * N_SAMPLES)(*n_terms),
                         None if scratch is None else scratch.data_ptr(), B, spec.n_repeats,
                         spec.dim, spec.filters, spec.n_iters, spec.ftol, variant, sign,
                         -sign * stack.an_const, plan.c_args,
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_resflow wide {direction} kernel failed to launch: "
                           f"CUDA error {err}")
    LAUNCHES[counter] += 1
    return (y, ld) if logdet else y


def launch(stack: PackedResFlow, x: torch.Tensor, direction: str,
           probes: Optional[Probes] = None):
    """Launch the CUDA kernel on ``x`` (B, D).  ``direction`` 'forward'
    (fwd_ld) or 'inverse' (solve_ld) returns (y, logdet (B,)) and needs
    ``probes``; 'solve' returns x, from the kernel ``solve_kernel`` picks
    (the wide kernel past WIDTHS or DIMS)."""
    with span(launch_span(stack, direction)):
        return _launch(stack, x, direction, probes)


def launch_span(stack: PackedResFlow, direction: str) -> str:
    """The launch's span: ``launch.<LAUNCHES key>.<kernel>``, the kernel
    'tile' (the series template, and the solve past SOLVE_WIDTHS), 'warp'
    (the solve kernel) or 'wide' (past WIDTHS or DIMS)."""
    kw = stack.kernel
    if isinstance(kw, WideWeights):
        kernel = "wide"
    elif direction == "solve" and kw is not None and solve_kernel(kw.fp) == "warp":
        kernel = "warp"
    else:
        kernel = "tile"
    return f"launch.{_variant(direction)[1]}.{kernel}"


def _launch(stack, x, direction, probes):
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
    if isinstance(kw, WideWeights):
        return _launch_wide(stack, x, direction, probes, None, n_terms if logdet else None)
    y = torch.empty_like(x)
    ld = torch.empty(B, dtype=torch.float32, device=x.device) if logdet else None
    if B == 0:
        return (y, ld) if logdet else y
    sign = 1.0 if direction == "forward" else -1.0
    nt = (ctypes.c_int * N_SAMPLES)(*n_terms)
    if direction == "solve" and solve_kernel(kw.fp) == "warp":
        with torch.cuda.device(x.device):
            err = _solve_fn()(x.data_ptr(), y.data_ptr(), kw.w.data_ptr(), B, spec.n_repeats,
                              spec.dim, spec.filters, kw.fp, kw.dp, spec.n_iters, spec.ftol,
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_resflow solve kernel failed to launch: CUDA error {err}")
        LAUNCHES[counter] += 1
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
