"""Whole-stack fused eval kernel for RealNVP / Glow density flows, on Hopper.

Counterpart of ``nf_tpu/ops/pallas/fused_stack.py``; two CUDA kernels
replace its Pallas kernels ``_make_kernels`` -> ``fwd_kernel`` /
``inv_kernel`` in both variants, RealNVP (flow-BatchNorm norms, no mix)
and Glow (ActNorm norms and the PLU 1x1 mix):
``nf_tpu_torch/csrc/fused_stack_mma.cu`` runs the conditioner's F x F
layers on the tensor cores (``mma.sync`` in 3xTF32) for padded widths up
to 64 and data dimensions up to 8, which includes the headline (D = 2,
F = 32);
``nf_tpu_torch/csrc/fused_stack.cuh`` runs them on the FFMA units for the
rest (built from ``fused_stack.cu``), with 16 samples a block where a wide
D would pass the shared memory at its usual tiling; past that, and in its
place at ``CLUSTER_PAST_TILES``' widths,
``nf_tpu_torch/csrc/fused_stack_wide.cu`` runs the stack on thread block
clusters of ``CLUSTER`` blocks that share a tile of samples, each holding
its rows of the x tile in shared memory, or past ``SPILL_BELOW`` samples
in device memory (``ffma_plan``, ``wide_plan``).  ``kernel_variant``
chooses by shape; every stack ``extract_stack_spec`` matches, at any D,
has a kernel.  The eval-mode forward or inverse of

    n x [ channel-affine norm -> (PLU 1x1 mix)? -> affine coupling(MLP) ]

runs as ONE launch per direction.  Host side, once per stack:

* ``extract_stack_spec`` matches the chain against that structure, by
  ``nf_tpu``'s rules;
* ``pack_stack`` folds weight norm, the conditioner BatchNorms' eval
  affines, the norm's shift / scale (flow-BatchNorm or ActNorm), the PLU
  recomposition ``W = P L U`` with its inverse, and every constant log-det,
  and lays the weights out per parity exactly as ``nf_tpu`` does, so the
  two can be compared array by array;
* ``PackedStack`` keeps that and, for a stack on the card, the kernel's
  own layout (``kernel_weights``): for the tensor-core kernel a header per
  coupling and direction and the F x F layers' B fragments, their input
  rows permuted and split for 3xTF32 (``MmaLayout``, ``mma_weights``);
  for the FFMA kernels per coupling, k-major, padded (``ffma_weights``;
  the cluster kernel's mix transposed, ``cluster_mix``).

``fused_stack`` is the wrapper: for CPU tensors it runs
``fused_stack_reference``, the plain PyTorch version of the same math; for
CUDA tensors it launches the kernel or raises, and counts the launch in
``LAUNCHES``.  Each launch is the span ``launch.<LAUNCHES key>.<kernel
path>`` (``launch_span``: 'mma', or the FFMA plan's path).

Bound (H100 SXM): per sample and coupling the conditioner does
``in*F + 4*F*F + 2*out*F`` multiply-adds (4,192 at D = 2, F = 32) and
about 22*F elementwise operations; the weights are read once (about 0.6 MB
at n = 32) and x / y / logdet are a few bytes per sample, so operations
bound the kernels, not memory: the F x F products on the tensor cores in
3xTF32, the rest on the CUDA cores.  The Glow mix adds 2*D*D flop per
sample and coupling.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ...bijectors.conv1x1 import InvertibleConv1x1
from ...bijectors.coupling import AffineCoupling
from ...bijectors.norm import ActNorm, BatchNorm
from ...core.bijector import Chain
from ...nets.conditioners import ResBlockLinear
from ...nets.core import Activation, Sequential
from ...nets.layers import _WN_EPS, BatchNormNet, Dense
from ...utils.tracing import span
from . import _build

# number of (F,)-vectors packed per coupling into the VEC array:
# b0 | rb0: A1 B1 b1 A2 B2 b2 | rb1: A1 B1 b1 A2 B2 b2 | head: Ah Bh
_N_VEC = 15

# FFMA kernel tiling per padded width FP: (S samples per block, TS samples
# per thread).  Each thread owns a TS x 4 (samples x features) tile of every
# conditioner layer, so a block has (S / TS) * (FP / 4) threads.
TILES = {8: (256, 4), 16: (128, 4), 32: (64, 2), 64: (64, 4),
         128: (32, 4), 256: (32, 4)}
# the tiling of every width for a stack whose block would pass SMEM_LIMIT at
# TILES' S: the x tile and the head's rows are D x (S + 4) floats, so 16
# samples a block take D up to several hundred at F = 32; past that the
# cluster kernel (``ffma_plan``)
NARROW_TILE = (16, 2)
# the padded widths at which the cluster kernel takes, in NARROW_TILE's
# place, the stacks that pass TILES' block, RealNVP (False) and Glow (True):
# where it ran faster at B = 1,000 and at 8,192, or within 4 % (Glow at
# 128), at the first and last D of each width (stack_cluster_probe.py
# narrow, H100); at the other widths the 16-sample tiling was faster at
# 8,192 (RealNVP 8, 16 and 64 at the narrowest D, 128, 256; Glow 256)
CLUSTER_PAST_TILES = {False: (32,), True: (8, 16, 32, 64, 128)}
SMEM_LIMIT = 232448   # dynamic shared memory one Hopper block may use
# The cluster kernel (csrc/fused_stack_wide.cu): CLUSTER blocks of
# CLUSTER_THREADS threads share a tile of S samples (the most of
# CLUSTER_SAMPLES whose member fits SMEM_LIMIT: 48 puts B = 1000 in one
# wave of the 30 clusters an H100 holds at once, and B = 8,192 in 6 where
# 32 samples take 9), member m holding rows [m Dc, m Dc + Dc) of the x tile
# (``member_rows``) and running the conditioner on samples
# [m S / 4, (m + 1) S / 4); the mix streams W^T in chunks of MIX_ROWS rows,
# a thread taking at most TILE_ITEMS mix tiles of 4 rows x 4 samples a pass
# over W^T; as many in-projection tiles of 4 features x 4 samples and as
# many conditioner tiles of one feature x 4 samples.  Each member's weights
# stream through RING_SLOTS slots of RING_FLOATS; its conditioner buffers'
# rows are COND_STRIDE floats.  Where the x tile fits shared memory only
# below SPILL_BELOW samples, it goes to device memory ('ffma_cluster_spill',
# ``spill_floats`` a member) at the most samples whose member fits.
CLUSTER = 4
CLUSTER_THREADS = 512
CLUSTER_SAMPLES = (48, 32, 16, 8, 4)
SPILL_BELOW = 16
RING_SLOTS = 4
RING_FLOATS = 4096
MIX_ROWS = 16
TILE_ITEMS = 2
COND_STRIDE = 12

# The tensor-core kernel: padded widths and data dimensions it covers, and
# its blocks of MMA_WARPS consumer warps of 16 samples (one warpgroup) and
# one producer warp.
MMA_WIDTHS = (8, 16, 32, 64)
MMA_DIMS = (2, 8)
MMA_WARPS = 4
MMA_SAMPLES = 16 * MMA_WARPS

# launches of each kernel variant, counted by the wrapper where it launches:
# fused_stack_* for RealNVP (no mix), fused_stack_glow_* for Glow (mix)
LAUNCHES = {"fused_stack_fwd": 0, "fused_stack_inv": 0,
            "fused_stack_glow_fwd": 0, "fused_stack_glow_inv": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# structural detection
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class StackSpec:
    n_repeats: int          # total repeats (even)
    dim: int                # data dimensionality D
    filters: int            # MLP width F
    has_mix: bool           # PLU 1x1 between norm and coupling (Glow)
    norm_kind: str          # 'batchnorm' (RealNVP) | 'actnorm' (Glow)
    # per-parity split sizes: (len(z0), len(z1)) for even / odd couplings
    halves: Tuple[Tuple[int, int], Tuple[int, int]]


def padded_width(filters: int) -> int:
    """The kernel's width for an F-wide conditioner (zero-padded)."""
    return min(fp for fp in TILES if fp >= filters)


def kernel_variant(dim: int, filters: int) -> str:
    """The kernel a (D = dim, F = filters) stack runs on the card, by shape
    alone: 'mma' (tensor cores) up to a padded width of 64 and D <= 8,
    'ffma' past either."""
    fits = padded_width(filters) <= max(MMA_WIDTHS) and dim <= max(MMA_DIMS)
    return "mma" if fits else "ffma"


def mma_dim(dim: int) -> int:
    """The tensor-core kernel's padded data dimension for D = dim."""
    return min(dp for dp in MMA_DIMS if dp >= dim)


@dataclass(frozen=True)
class MmaLayout:
    """The tensor-core kernel's weight layout at padded width ``fp`` and
    data dimension ``dp``; csrc/fused_stack_mma.cu's Header, Layer and
    smem_bytes mirror it.  A
    coupling's header, in floats: vec [15][fp] | w0 [half][fp] | wh
    [2 half][fp] (t rows, then s rows from half) | bh [2 half] | gb [2] |
    pre [dp][2] | mix [dp][dp], padded to 4, half = dp / 2.  A layer, its
    input rows permuted (``input_permutation``): the B fragments
    [fp/8][fp/8][32][4] (big, big, small, small; ``b_fragment_index``)."""
    fp: int
    dp: int

    @property
    def half(self) -> int:
        return self.dp // 2

    @property
    def w0(self) -> int:
        return _N_VEC * self.fp

    @property
    def wh(self) -> int:
        return self.w0 + self.half * self.fp

    @property
    def bh(self) -> int:
        return self.wh + 2 * self.half * self.fp

    @property
    def gb(self) -> int:
        return self.bh + 2 * self.half

    @property
    def pre(self) -> int:
        return self.gb + 2

    @property
    def mix(self) -> int:
        return self.pre + 2 * self.dp

    @property
    def header(self) -> int:
        return (self.mix + self.dp * self.dp + 3) // 4 * 4

    @property
    def layer(self) -> int:
        return (self.fp // 8) ** 2 * 32 * 4

    @property
    def stages(self) -> int:
        """Layer slots in the block's weight ring."""
        return 8 if self.fp <= 32 else 4

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block: 256 bytes of mbarriers, the
        ring and two header slots."""
        return 256 + 4 * (self.stages * self.layer + 2 * self.header)


def member_rows(dim: int) -> int:
    """The cluster kernel's x rows of a member: ceil(D / CLUSTER), rounded
    up to 4."""
    return (-(-dim // CLUSTER) + 3) // 4 * 4


def spill_floats(samples: int, dim: int, has_mix: bool) -> int:
    """Device memory of one cluster member on 'ffma_cluster_spill': its x
    rows (two buffers for the mix) and its rows' s, for the cluster's
    samples."""
    dc = member_rows(dim)
    return ((2 if has_mix else 1) * dc + dc // 2) * (samples + 4)


def smem_bytes(fp: int, samples: int, dim: int, has_mix: bool = False,
               wide: bool = False, spill: bool = False) -> int:
    """Dynamic shared memory of one FFMA kernel block; the kernel computes
    the same.  ``wide``: one member of the cluster kernel (its WideLayout):
    its x rows (two buffers for the mix), the in-projection partials /
    gathered head input and the coupling's s of its rows for the cluster's
    samples, the conditioner's h and two activations of its samples, the
    weight ring, for Glow the mix's W^T and x chunk rings, its share of
    the log-det and the ring's mbarriers; with ``spill`` the x rows, s and
    W^T ring are in device memory (``spill_floats``)."""
    sp = samples + 4
    chunk = fp if fp * fp <= 4096 else 4096 // fp
    if wide:
        dc = 0 if spill else member_rows(dim)
        mix = 2 * MIX_ROWS * (dc + sp) if has_mix else 0
        return 4 * ((2 if has_mix else 1) * dc * sp + fp * sp + dc // 2 * sp
                    + 3 * fp * COND_STRIDE + RING_SLOTS * RING_FLOATS + mix + samples
                    + 2 * RING_SLOTS)
    half = (dim + 1) // 2
    # per coupling: vec, in-projection, head, then bh / gb / pre / mix
    # padded to 4
    small = 2 * half + 2 + 2 * dim + (dim * dim if has_mix else 0)
    header = (_N_VEC + 3 * half) * fp + (small + 3) // 4 * 4
    return 4 * (2 * fp * sp + 2 * chunk * fp + 2 * header + dim * sp
                + 2 * half * sp + samples)


def wide_plan(dim: int, filters: int, has_mix: bool, spill: bool = False) -> Optional[int]:
    """The cluster kernel's samples a cluster, its x tiles in shared
    memory (down to SPILL_BELOW samples) or with ``spill`` in device
    memory: the first of CLUSTER_SAMPLES whose member fits SMEM_LIMIT and
    whose in-projection and conditioner tiles fit the threads' tile budget
    (TILE_ITEMS); None past them all."""
    fp = padded_width(filters)
    budget = TILE_ITEMS * CLUSTER_THREADS
    for samples in CLUSTER_SAMPLES:
        if not spill and samples < SPILL_BELOW:
            break
        tiles_ok = (fp // 4 * (samples // 4) <= budget
                    and fp * -(-samples // CLUSTER // 4) <= budget)
        if tiles_ok and smem_bytes(fp, samples, dim, has_mix, True, spill) <= SMEM_LIMIT:
            return samples
    return None


def ffma_plan(dim: int, filters: int, has_mix: bool) -> Tuple[str, Tuple[int, int]]:
    """The FFMA kernels' path and tiling for a (D = dim, F = filters)
    stack: TILES' (S, TS) of its padded width ('ffma') where that fits one
    block's shared memory; else, outside CLUSTER_PAST_TILES' widths,
    NARROW_TILE ('ffma_narrow') where that fits; else the cluster kernel
    ('ffma_cluster') with (samples a cluster, CLUSTER) from ``wide_plan``;
    past that its x tiles in device memory ('ffma_cluster_spill'), which
    takes any D."""
    fp = padded_width(filters)
    if smem_bytes(fp, TILES[fp][0], dim, has_mix) <= SMEM_LIMIT:
        return "ffma", TILES[fp]
    if (fp not in CLUSTER_PAST_TILES[has_mix]
            and smem_bytes(fp, NARROW_TILE[0], dim, has_mix) <= SMEM_LIMIT):
        return "ffma_narrow", NARROW_TILE
    samples = wide_plan(dim, filters, has_mix)
    if samples is not None:
        return "ffma_cluster", (samples, CLUSTER)
    return "ffma_cluster_spill", (wide_plan(dim, filters, has_mix, spill=True), CLUSTER)


def ffma_tiling(dim: int, filters: int, has_mix: bool) -> Tuple[int, int]:
    """The FFMA kernels' tiling for a (D = dim, F = filters) stack
    (``ffma_plan``)."""
    return ffma_plan(dim, filters, has_mix)[1]


def _is_relu(layer) -> bool:
    return isinstance(layer, Activation) and layer.fn is torch.relu


def _mlp_ok(net, filters_out: int) -> Optional[int]:
    """Validate the standard MLP shape; returns width F or None."""
    if not isinstance(net, Sequential) or len(net.layers) != 6:
        return None
    l0, r0, r1, bn, act, lh = net.layers
    if not (isinstance(l0, Dense) and isinstance(lh, Dense)
            and isinstance(bn, BatchNormNet) and _is_relu(act)):
        return None
    F = l0.out_features
    for rb in (r0, r1):
        if not isinstance(rb, ResBlockLinear) or rb.bridge is not None:
            return None
        sub = rb.net.layers
        if len(sub) != 6:
            return None
        if not (isinstance(sub[0], BatchNormNet) and _is_relu(sub[1])
                and isinstance(sub[2], Dense) and isinstance(sub[3], BatchNormNet)
                and _is_relu(sub[4]) and isinstance(sub[5], Dense)):
            return None
        if sub[2].in_features != F or sub[2].out_features != F \
                or sub[5].in_features != F or sub[5].out_features != F:
            return None
    if lh.in_features != F or lh.out_features != 2 * filters_out:
        return None
    return F


def extract_stack_spec(chain, dims) -> Optional[StackSpec]:
    """Match chain.layers against the fusable repeated structure, by
    ``nf_tpu``'s rules but its 8 MB cap on the stacked weights (TPU VMEM;
    the Hopper kernels stream each coupling's weights from L2).  What a
    kernel on the card takes is asked where the stack is packed for the
    card (``PackedStack``, ``ffma_tiling``): a matched stack is never
    served by the eager chain there."""
    if not isinstance(chain, Chain) or len(dims) != 1:
        return None
    D = dims[0]
    layers = list(chain.layers)
    if not layers:
        return None
    has_mix = len(layers) > 1 and isinstance(layers[1], InvertibleConv1x1)
    per = 3 if has_mix else 2
    if len(layers) % per != 0:
        return None
    n = len(layers) // per
    if n < 2 or n % 2 != 0:
        return None

    norm_kind = None
    F = None
    halves = [None, None]
    for i in range(n):
        grp = layers[per * i: per * (i + 1)]
        norm, coup = grp[0], grp[-1]
        if isinstance(norm, BatchNorm) and not norm.affine:
            kind = "batchnorm"
        elif isinstance(norm, ActNorm):
            kind = "actnorm"
        else:
            return None
        if norm_kind not in (None, kind):
            return None
        norm_kind = kind
        if has_mix and not isinstance(grp[1], InvertibleConv1x1):
            return None
        if not isinstance(coup, AffineCoupling) or coup.odd != (i % 2 != 0):
            return None
        out_chs, in_chs = coup.half_dims()
        f = _mlp_ok(coup.net, out_chs)
        if f is None or (F is not None and f != F):
            return None
        F = f
        halves[i % 2] = (out_chs, in_chs)

    if F > max(TILES):
        return None
    return StackSpec(n_repeats=n, dim=D, filters=F, has_mix=has_mix,
                     norm_kind=norm_kind, halves=(halves[0], halves[1]))


# --------------------------------------------------------------------------
# host-side packing, once per stack
# --------------------------------------------------------------------------
def _stacked(tensors):
    return torch.stack([t.detach() for t in tensors])


def _dense_weight_batched(layers):
    """Stacked effective dense weights: (m, out, in)."""
    if layers[0].weight_norm:
        v = _stacked([l.v for l in layers])                 # (m, out, in)
        g = _stacked([l.g for l in layers])                 # (m, in)
        vnorm = torch.linalg.vector_norm(v, dim=1)          # (m, in)
        return v * (g / (vnorm + _WN_EPS))[:, None, :]
    return _stacked([l.w for l in layers])


def _bn_eval_affine_batched(bns):
    """BatchNormNet eval as y = x*A + B, stacked: (m, F) each."""
    gamma = _stacked([b.gamma for b in bns])
    beta = _stacked([b.beta for b in bns])
    mean = _stacked([b.running_mean for b in bns])
    var = _stacked([b.running_var for b in bns])
    A = gamma * torch.rsqrt(var + bns[0].eps)
    return A, beta - mean * A


@torch.no_grad()
def pack_stack(chain, spec: StackSpec):
    """Stack per-parity weights (``nf_tpu``'s layout); fold all constant
    logdets into a scalar.

    Returns (packed, const_ld): packed[parity] holds
      pre  (m, D, 2)      forward (shift, scale) of the norm layer
      prei (m, D, 2)      inverse (shift, 1/scale)
      mix  (m, D, D)      W = P L U, applied as x @ W.T   [has_mix only]
      mixi (m, D, D)      W^-1 in f32                     [has_mix only]
      W0   (m, F, in)     in-proj (out, in)
      VEC  (m, F, 15)     BN eval affines + dense biases, order of _N_VEC
      WR   (m, 4, F, F)   resblock weights (out, in)
      Wh   (m, 2out, F)   head weight (out, in)
      bh   (m, 2out, 1)   head bias
      gb   (m, 2)         coupling (s_log_scale, s_bias)
    and const_ld (0-d) is the forward-direction constant contribution.
    """
    per = 3 if spec.has_mix else 2
    n = spec.n_repeats
    layers = chain.layers
    const_ld = torch.zeros((), dtype=torch.float32,
                           device=layers[-1].s_bias.device)
    packed = []
    for parity in range(2):
        idxs = range(parity, n, 2)
        b = {}

        # ---- norm layer: channel affine + constant logdet
        norms = [layers[per * i] for i in idxs]
        if spec.norm_kind == "batchnorm":
            rv = _stacked([l.running_var for l in norms])   # (m, D)
            shift = _stacked([l.running_mean for l in norms])
            scale = torch.rsqrt(rv)
            const_ld = const_ld - 0.5 * torch.sum(torch.log(rv))
        else:   # actnorm
            log_scale = _stacked([l.log_scale for l in norms])
            shift = _stacked([l.bias for l in norms])
            scale = torch.exp(-log_scale)
            const_ld = const_ld - torch.sum(log_scale)
        b["pre"] = torch.stack([shift, scale], dim=2)
        b["prei"] = torch.stack([shift, 1.0 / scale], dim=2)

        # ---- PLU 1x1 mix
        if spec.has_mix:
            convs = [layers[per * i + 1] for i in idxs]
            W = torch.stack([c.weight().detach() for c in convs])   # (m, D, D)
            b["mix"] = W
            # one matrix at a time: a batched CPU LU (MKL getrf with more
            # than one thread) can fail to return past about 128 rows
            b["mixi"] = torch.stack([torch.linalg.inv(w) for w in W])
            const_ld = const_ld + torch.sum(_stacked([c.log_s for c in convs]))

        # ---- coupling conditioner (standard MLP, eval mode)
        coups = [layers[per * i + per - 1] for i in idxs]
        nets = [c.net.layers for c in coups]
        vec = [_stacked([l[0].b for l in nets])]
        WR = []
        for r in (1, 2):
            subs = [l[r].net.layers for l in nets]
            A1, B1 = _bn_eval_affine_batched([s[0] for s in subs])
            A2, B2 = _bn_eval_affine_batched([s[3] for s in subs])
            vec += [A1, B1, _stacked([s[2].b for s in subs]),
                    A2, B2, _stacked([s[5].b for s in subs])]
            WR += [_dense_weight_batched([s[2] for s in subs]),
                   _dense_weight_batched([s[5] for s in subs])]
        Ah, Bh = _bn_eval_affine_batched([l[3] for l in nets])
        vec += [Ah, Bh]
        b["W0"] = _dense_weight_batched([l[0] for l in nets])
        b["VEC"] = torch.stack(vec, dim=2)
        b["WR"] = torch.stack(WR, dim=1)
        b["Wh"] = _dense_weight_batched([l[5] for l in nets])
        b["bh"] = _stacked([l[5].b for l in nets])[..., None]
        b["gb"] = torch.cat([_stacked([c.s_log_scale for c in coups]),
                             _stacked([c.s_bias for c in coups])], dim=1)
        packed.append(b)
    return packed, const_ld


# --------------------------------------------------------------------------
# plain PyTorch version, (B, D) layout
# --------------------------------------------------------------------------
def _row_sets(D):
    return list(range(0, D, 2)), list(range(1, D, 2))


def _mlp(P, j, z1):
    """The standard MLP conditioner, eval mode: z1 (B, in) -> (B, 2*out)."""
    V = P["VEC"][j]                                         # (F, 15)
    h = z1 @ P["W0"][j].T + V[:, 0]
    for r in range(2):
        o = 1 + 6 * r
        u = torch.relu(h * V[:, o] + V[:, o + 1])
        u = u @ P["WR"][j, 2 * r].T + V[:, o + 2]
        u = torch.relu(u * V[:, o + 3] + V[:, o + 4])
        u = u @ P["WR"][j, 2 * r + 1].T + V[:, o + 5]
        h = h + u
    h = torch.relu(h * V[:, 13] + V[:, 14])
    return h @ P["Wh"][j].T + P["bh"][j, :, 0]


def _layer(P, j, odd, x, ld, inverse):
    rows_even, rows_odd = _row_sets(x.shape[1])
    r0, r1 = (rows_odd, rows_even) if odd else (rows_even, rows_odd)
    if not inverse:
        pre = P["pre"][j]
        x = (x - pre[:, 0]) * pre[:, 1]
        if "mix" in P:
            x = x @ P["mix"][j].T
    raw = _mlp(P, j, x[:, r1])
    oc = len(r0)
    t, raw_s = raw[:, :oc], raw[:, oc:]
    s = torch.tanh(raw_s) * P["gb"][j, 0] + P["gb"][j, 1]
    x = x.clone()
    if inverse:
        x[:, r0] = (x[:, r0] - t) * torch.exp(-s)
        ld = ld - s.sum(dim=1)
        if "mixi" in P:
            x = x @ P["mixi"][j].T
        prei = P["prei"][j]
        x = x * prei[:, 1] + prei[:, 0]
    else:
        x[:, r0] = x[:, r0] * torch.exp(s) + t
        ld = ld + s.sum(dim=1)
    return x, ld


def _is_inverse(direction: str) -> bool:
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
    return direction == "inverse"


def fused_stack_reference(packed, const_ld, x, direction: str):
    """Plain PyTorch version of the fused kernel: (y, logdet (B,))."""
    inverse = _is_inverse(direction)
    x = x.to(torch.float32)
    m = packed[0]["gb"].shape[0]
    ld = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if inverse:
        for j in reversed(range(m)):
            x, ld = _layer(packed[1], j, True, x, ld, True)
            x, ld = _layer(packed[0], j, False, x, ld, True)
        return x, ld - const_ld
    for j in range(m):
        x, ld = _layer(packed[0], j, False, x, ld, False)
        x, ld = _layer(packed[1], j, True, x, ld, False)
    return x, ld + const_ld


# --------------------------------------------------------------------------
# the kernels' layouts and their wrapper
# --------------------------------------------------------------------------
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 on its bits (13 low mantissa bits cleared, to
    nearest, ties away from zero), as csrc/fused_stack_mma.cu rounds."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def input_permutation(fp: int) -> torch.Tensor:
    """(fp,): the input feature at each row position of the tensor-core
    kernel's layers.  Within each group of 8, position t takes feature
    8 j + 2 t and position t + 4 feature 8 j + 2 t + 1, the two features a
    lane holds of a C fragment's n-tile j, so that fragment is the next
    layer's A fragment as it stands."""
    p = torch.arange(fp)
    q = p % 8
    return p - q + torch.where(q < 4, 2 * q, 2 * (q - 4) + 1)


def b_fragment_index(fp: int):
    """(outs, ins), each (fp/8, fp/8, 32, 2): the weight W[out, in] that lane
    l holds in register r of an m16n8k8 TF32 B fragment of k-step ks and
    n-tile nt, the rows (k) permuted by ``input_permutation``: r = 0 is
    k-position 8 ks + t, r = 1 is 8 ks + t + 4, both of column (out)
    8 nt + g, with g = l // 4 and t = l % 4."""
    ks = torch.arange(fp // 8)[:, None, None, None]
    nt = torch.arange(fp // 8)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    r = torch.arange(2)[None, None, None, :]
    shape = (fp // 8, fp // 8, 32, 2)
    outs = (8 * nt + lane // 4).expand(shape)
    ins = input_permutation(fp)[(8 * ks + lane % 4 + 4 * r).expand(shape)]
    return outs, ins


@dataclass(frozen=True)
class MmaWeights:
    """The tensor-core kernel's weights: ``hdr`` (2, n, header) the
    forward's and the inverse's header per coupling c (pre: (shift, scale)
    / (shift, 1/scale); mix: W / W^-1), ``frag`` (n, 4, layer) the four
    F x F layers' B fragments; ``pointers`` the launch's (hdr, frag)
    addresses per direction, taken once (the host's cost per call is close
    to the headline kernel's time)."""
    layout: MmaLayout
    hdr: torch.Tensor
    frag: torch.Tensor
    pointers: Tuple[Tuple[int, int], Tuple[int, int]]

    @property
    def fp(self) -> int:
        return self.layout.fp


@torch.no_grad()
def mma_weights(spec: StackSpec, packed) -> MmaWeights:
    n, D, F = spec.n_repeats, spec.dim, spec.filters
    lay = MmaLayout(padded_width(F), mma_dim(D))
    fp, dp, half = lay.fp, lay.dp, lay.half
    if fp not in MMA_WIDTHS:
        raise ValueError(f"fused_stack_mma has no tiling for padded width {fp}")
    kw = dict(dtype=torch.float32, device=packed[0]["gb"].device)
    vec = torch.zeros(n, _N_VEC, fp, **kw)
    w0 = torch.zeros(n, half, fp, **kw)
    wh = torch.zeros(n, 2 * half, fp, **kw)
    bh = torch.zeros(n, 2 * half, **kw)
    gb = torch.zeros(n, 2, **kw)
    pre = torch.zeros(2, n, dp, 2, **kw)
    mix = torch.zeros(2, n, dp, dp, **kw)
    dense = torch.zeros(n, 4, fp, fp, **kw)      # (out, in)
    for parity in range(2):
        P = packed[parity]
        c = slice(parity, n, 2)
        oc, ic = spec.halves[parity]
        vec[c, :, :F] = P["VEC"].transpose(1, 2)
        w0[c, :ic, :F] = P["W0"].transpose(1, 2)
        wh[c, :oc, :F] = P["Wh"][:, :oc]
        wh[c, half:half + oc, :F] = P["Wh"][:, oc:]
        bh[c, :oc] = P["bh"][:, :oc, 0]
        bh[c, half:half + oc] = P["bh"][:, oc:, 0]
        gb[c] = P["gb"]
        pre[0, c, :D] = P["pre"]
        pre[1, c, :D] = P["prei"]
        if spec.has_mix:
            mix[0, c, :D, :D] = P["mix"]
            mix[1, c, :D, :D] = P["mixi"]
        dense[c, :, :F, :F] = P["WR"]
    pad = torch.zeros(n, lay.header - lay.mix - dp * dp, **kw)
    hdr = torch.stack([torch.cat([vec.flatten(1), w0.flatten(1), wh.flatten(1), bh, gb,
                                  pre[d].flatten(1), mix[d].flatten(1), pad], dim=1)
                       for d in range(2)])
    outs, ins = b_fragment_index(fp)
    b = dense[:, :, outs, ins]                   # (n, 4, fp/8, fp/8, 32, 2)
    big = tf32_round(b)
    b = torch.cat([big, b - big], dim=-1)         # b0 big, b1 big, b0 small, b1 small
    hdr, frag = hdr.contiguous(), b.reshape(n, 4, -1).contiguous()
    pointers = tuple((hdr[d].data_ptr(), frag.data_ptr()) for d in range(2))
    return MmaWeights(lay, hdr, frag, pointers)


@dataclass(frozen=True)
class FfmaWeights:
    """The FFMA kernel's weights per coupling c = 2*j + parity, zero-padded
    to width fp: pre / prei (n, D, 2), w0t (n, in_max, fp) k-major, vec
    (n, 15, fp), wrt (n, 4, fp, fp) k-major, wh (n, 2*out_max, fp) with the
    t rows first and the s rows from out_max, bh (n, 2*out_max), gb (n, 2),
    and for Glow mix / mixi (n, D, D) row-major (out, in), else None (on
    the cluster path W^T / W^-T as ``cluster_mix`` lays them out);
    ``tile`` and ``path`` ``ffma_plan``'s: (S samples a block, TS a
    thread) on 'ffma' and 'ffma_narrow', (S samples a cluster, CLUSTER) on
    'ffma_cluster' and 'ffma_cluster_spill'."""
    fp: int
    tile: Tuple[int, int]
    path: str
    pre: torch.Tensor
    prei: torch.Tensor
    w0t: torch.Tensor
    vec: torch.Tensor
    wrt: torch.Tensor
    wh: torch.Tensor
    bh: torch.Tensor
    gb: torch.Tensor
    mix: Optional[torch.Tensor] = None
    mixi: Optional[torch.Tensor] = None


@torch.no_grad()
def ffma_weights(spec: StackSpec, packed) -> FfmaWeights:
    n, D, F = spec.n_repeats, spec.dim, spec.filters
    fp = padded_width(F)
    path, tile = ffma_plan(D, F, spec.has_mix)
    half = (D + 1) // 2                   # in_max == out_max
    kw = dict(dtype=torch.float32, device=packed[0]["gb"].device)
    out = dict(pre=torch.zeros(n, D, 2, **kw), prei=torch.zeros(n, D, 2, **kw),
               w0t=torch.zeros(n, half, fp, **kw),
               vec=torch.zeros(n, _N_VEC, fp, **kw),
               wrt=torch.zeros(n, 4, fp, fp, **kw),
               wh=torch.zeros(n, 2 * half, fp, **kw),
               bh=torch.zeros(n, 2 * half, **kw), gb=torch.zeros(n, 2, **kw))
    if spec.has_mix:
        out["mix"] = torch.zeros(n, D, D, **kw)
        out["mixi"] = torch.zeros(n, D, D, **kw)
    for parity in range(2):
        P = packed[parity]
        c = slice(parity, n, 2)
        oc, ic = spec.halves[parity]
        out["pre"][c] = P["pre"]
        out["prei"][c] = P["prei"]
        out["w0t"][c, :ic, :F] = P["W0"].transpose(1, 2)
        out["vec"][c, :, :F] = P["VEC"].transpose(1, 2)
        out["wrt"][c, :, :F, :F] = P["WR"].transpose(2, 3)
        out["wh"][c, :oc, :F] = P["Wh"][:, :oc]
        out["wh"][c, half:half + oc, :F] = P["Wh"][:, oc:]
        out["bh"][c, :oc] = P["bh"][:, :oc, 0]
        out["bh"][c, half:half + oc] = P["bh"][:, oc:, 0]
        out["gb"][c] = P["gb"]
        if spec.has_mix:
            out["mix"][c] = P["mix"]
            out["mixi"][c] = P["mixi"]
    if spec.has_mix and path.startswith("ffma_cluster"):
        out["mix"], out["mixi"] = cluster_mix(out["mix"]), cluster_mix(out["mixi"])
    return FfmaWeights(fp=fp, tile=tile, path=path, **out)


def cluster_mix(mix: torch.Tensor) -> torch.Tensor:
    """The cluster kernel's mix layout of (n, D, D) row-major (out, in)
    matrices: W^T, (n, D, CLUSTER * member_rows(D)), row k holding W[:, k],
    the columns past D zero, so member m reads columns [m Dc, m Dc + Dc)
    of each row in 16-byte copies."""
    n, D, _ = mix.shape
    out = mix.new_zeros(n, D, CLUSTER * member_rows(D))
    out[:, :, :D] = mix.transpose(1, 2)
    return out


def kernel_weights(spec: StackSpec, packed):
    """The weights in the layout of the kernel ``kernel_variant`` picks."""
    if kernel_variant(spec.dim, spec.filters) == "mma":
        return mma_weights(spec, packed)
    return ffma_weights(spec, packed)


class PackedStack:
    """One stack's packed weights, built once: ``nf_tpu``'s layout for the
    plain version and, for a stack off the CPU, the kernel's layout."""

    def __init__(self, spec: StackSpec, packed, const_ld: torch.Tensor):
        self.spec = spec
        self.packed = packed
        self.const_ld = const_ld
        self.device = const_ld.device
        self.variant = kernel_variant(spec.dim, spec.filters)
        self.kernel = self.ld_const = None
        if self.device.type != "cpu":
            self.kernel = kernel_weights(spec, packed)
            self.ld_const = float(const_ld)
        self.spans = (launch_span(self, False), launch_span(self, True))   # by inverse


def _ffma_fn():
    fn = _build.load("fused_stack").nf_fused_stack
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _cluster_fn():
    fn = _build.load("fused_stack_wide").nf_fused_stack_wide
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 7 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _mma_fn():
    fn = _build.load("fused_stack_mma").nf_fused_stack_mma
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 7 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def mma_blocks_per_sm(kw: MmaWeights, has_mix: bool, inverse: bool) -> int:
    """Blocks of the tensor-core kernel's tiling that one SM of the current
    card holds at once (the CUDA occupancy API, with the kernel's threads
    and shared memory).  A batch of B launches ceil(B / MMA_SAMPLES)."""
    fn = _build.load("fused_stack_mma").nf_fused_stack_mma_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lay = kw.layout
    out = ctypes.c_int(0)
    err = fn(lay.fp, lay.dp, int(inverse), int(has_mix), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_stack_mma: occupancy query failed: CUDA error {err}")
    return out.value


def weight_bytes_to_sm(kw: MmaWeights, n: int, batch: int) -> int:
    """Bytes the tensor-core kernel copies from L2 into its blocks' shared
    memory in one direction at ``batch`` samples: every block reads every
    coupling's header and four layers once."""
    blocks = -(-batch // MMA_SAMPLES)
    return blocks * n * 4 * (kw.layout.header + 4 * kw.layout.layer)


def launch(stack: PackedStack, x: torch.Tensor, inverse: bool):
    """Launch the CUDA kernel on ``x`` (B, D): returns (y, logdet (B,))."""
    with span(stack.spans[inverse]):
        return _launch(stack, x, inverse)


def launch_span(stack: PackedStack, inverse: bool) -> str:
    """The launch's span: ``launch.<LAUNCHES key>.<kernel path>``, the path
    'mma' (the tensor-core kernel), 'ffma' (TILES), 'ffma_narrow'
    (NARROW_TILE), 'ffma_cluster' (the cluster kernel) or
    'ffma_cluster_spill' (its x tiles in device memory); a stack with no
    kernel weights (packed on the CPU) names its variant."""
    path = getattr(stack.kernel, "path", stack.variant)
    return f"launch.{launch_name(stack.spec, inverse)}.{path}"


def _launch(stack: PackedStack, x: torch.Tensor, inverse: bool):
    kw, spec = stack.kernel, stack.spec
    if not x.is_cuda:
        raise ValueError(f"fused_stack kernel needs a CUDA tensor, got {x.device}")
    held = None if kw is None else (kw.hdr if isinstance(kw, MmaWeights) else kw.gb).device
    if held != x.device:
        raise ValueError(f"fused_stack: weights on {stack.device}, x on {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != spec.dim \
            or not x.is_contiguous():
        raise ValueError("fused_stack kernel takes a contiguous float32 "
                         f"(B, {spec.dim}) tensor, got {x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    y = torch.empty_like(x)
    ld = x.new_empty(B)
    if B == 0:
        return y, ld
    ld_const = -stack.ld_const if inverse else stack.ld_const
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if isinstance(kw, MmaWeights):
            lay = kw.layout
            err = _mma_fn()(x.data_ptr(), y.data_ptr(), ld.data_ptr(), *kw.pointers[inverse],
                            B, spec.dim, spec.n_repeats, lay.fp, lay.dp, int(inverse),
                            int(spec.has_mix), ld_const, stream)
        else:
            S, TS = kw.tile
            mix = kw.mixi if inverse else kw.mix
            ptrs = [x.data_ptr(), y.data_ptr(), ld.data_ptr(),
                    (kw.prei if inverse else kw.pre).data_ptr(),
                    0 if mix is None else mix.data_ptr(), kw.w0t.data_ptr(),
                    kw.vec.data_ptr(), kw.wrt.data_ptr(), kw.wh.data_ptr(),
                    kw.bh.data_ptr(), kw.gb.data_ptr()]
            if kw.path.startswith("ffma_cluster"):
                spill = None
                if kw.path == "ffma_cluster_spill":
                    blocks = -(-B // S) * CLUSTER
                    spill = x.new_empty(blocks * spill_floats(S, spec.dim, spec.has_mix))
                err = _cluster_fn()(*ptrs, 0 if spill is None else spill.data_ptr(), B,
                                    spec.dim, spec.n_repeats, kw.fp, S, int(inverse),
                                    int(spec.has_mix), ld_const, stream)
            else:
                err = _ffma_fn()(*ptrs, B, spec.dim, spec.n_repeats, kw.fp, S, TS,
                                 int(inverse), int(spec.has_mix), ld_const, stream)
    if err != 0:
        raise RuntimeError(f"fused_stack {'inverse' if inverse else 'forward'} "
                           f"kernel failed to launch: CUDA error {err}")
    LAUNCHES[launch_name(spec, inverse)] += 1
    return y, ld


def launch_name(spec: StackSpec, inverse: bool) -> str:
    """The ``LAUNCHES`` key of this stack's kernel variant and direction."""
    variant = "fused_stack_glow" if spec.has_mix else "fused_stack"
    return f"{variant}_{'inv' if inverse else 'fwd'}"


def fused_stack(stack: PackedStack, x: torch.Tensor, direction: str):
    """Eval-mode forward or inverse of the whole stack: (y, logdet (B,)).

    CPU tensors take the plain version; any other tensor launches the
    kernel or raises."""
    inverse = _is_inverse(direction)
    if x.device.type == "cpu":
        return fused_stack_reference(stack.packed, stack.const_ld, x, direction)
    return launch(stack, x, inverse)
