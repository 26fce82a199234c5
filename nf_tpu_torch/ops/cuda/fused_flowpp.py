"""Whole-stack fused eval kernel for the Flow++ 2-D density stack, on Hopper.

Counterpart of ``nf_tpu/ops/pallas/fused_flowpp.py``; the CUDA kernel in
``nf_tpu_torch/csrc/fused_flowpp.cu`` replaces its Pallas kernels
``_make_kernels_flowpp`` -> ``fwd_kernel`` / ``inv_kernel``.  The eval-mode
forward or inverse of

    n x [ ActNorm(2) -> MixLogAttnCoupling(K-mixture, MLP-attn conditioner) ]

runs as ONE launch per direction.  At 1-D data the conditioner's attention
sees one token, so it collapses to a chain of small dense layers:

    Dense(1 -> F) -> GatedLinear(F) -> LayerNorm -> [A = Q-projection;
    gated out-projection] -> LayerNorm -> Dense(F -> 2 + 3K)

The forward evaluates the mixture's log-CDF; the inverse solves it with
the fixed-trip bracket-safeguarded Newton of ``bijectors/mixlogcdf.py``
(same constants).  Host side, once per stack:

* ``extract_flowpp_spec`` matches the chain against that structure;
* ``pack_flowpp`` folds ActNorm and the positional embedding (through the
  Q projection, ``bq_eff``) and lays the weights out per parity exactly as
  ``nf_tpu`` does, so the two can be compared array by array;
* ``PackedFlowpp`` keeps that and, for a stack on the card, the kernel's
  own layout (``kernel_weights``: one contiguous block per coupling,
  zero-padded to the kernel's width FP and mixture count KP).

``fused_flowpp`` is the wrapper: for CPU tensors it runs
``fused_flowpp_reference``, the plain PyTorch version of the same math;
for CUDA tensors it launches the kernel or raises, and counts the launch
in ``LAUNCHES``.

The kernel runs a group of ``LANES`` lanes per sample, ``SAMPLES`` samples
per block: each dense layer split by output feature, the LayerNorm and
log-sum-exp reductions by shuffles within the group, the mixture's
components split across its lanes, and the group's Newton trips taken
together (tests/test_torch_flowpp.py walks that split).

Bound (H100 SXM): per sample and coupling the conditioner does
``F + 2F^2 + F^2 + 2F^2 + (2+3K)F`` multiply-adds (5,984 at F = 32,
K = 8); the inverse adds up to 25 evaluations of the mixture, each about
5K + 3 transcendentals.  On the main path's data an element needs 7.5
evaluations on average, so f32 operations bound both directions.  The
weights (about 0.8 MB at n = 32) and x / y / logdet are read or written
once, far below either.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as Fn

from ...bijectors.flowpp_coupling import MixLogAttnCoupling
from ...bijectors.mixlogcdf import (mix_log_cdf_logit_forward,
                                   mix_log_cdf_logit_inverse)
from ...bijectors.norm import ActNorm
from ...core.bijector import Chain
from ...nets.core import Sequential
from ...nets.gated import GatedAttn, GatedLinear, LayerNormNet
from ...nets.layers import Dense
from ...utils.tracing import span
from . import _build

LN_EPS = 1.0e-5
LANES = 8               # lanes of one sample's group
SAMPLES = 32            # samples per block: 256 threads
SMEM_LIMIT = 232448     # dynamic shared memory one Hopper block may use
WIDTHS = (8, 16, 32, 64, 128)     # the kernel's padded conditioner widths FP
MIXTURES = (8, 32)                # and padded mixture counts KP

# launches of each kernel, counted by the wrapper where it launches
LAUNCHES = {"fused_flowpp_fwd": 0, "fused_flowpp_inv": 0}
SPANS = {False: "launch.fused_flowpp_fwd", True: "launch.fused_flowpp_inv"}  # by inverse


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(frozen=True)
class FlowppSpec:
    kind: str            # 'flowpp' (dispatch tag for EvalProgram)
    n_repeats: int       # couplings (even; parity alternates)
    dim: int             # == 2
    filters: int         # conditioner width F
    n_mixtures: int      # K


# --------------------------------------------------------------------------
# structural detection
# --------------------------------------------------------------------------
def extract_flowpp_spec(chain, dims) -> Optional[FlowppSpec]:
    """Match chain.layers against the fusable Flow++ density structure.

    ``nf_tpu`` also caps the packed weights at 8 MB of TPU VMEM; the Hopper
    kernel stages one coupling at a time (or reads the widest through L2),
    so F <= 128 and K <= 32 are its only limits."""
    if not isinstance(chain, Chain) or len(dims) != 1 or dims[0] != 2:
        return None
    layers = list(chain.layers)
    if len(layers) < 4 or len(layers) % 2 != 0:
        return None
    n = len(layers) // 2
    if n % 2 != 0:
        return None

    F = K = None
    for i in range(n):
        norm, coup = layers[2 * i], layers[2 * i + 1]
        if not isinstance(norm, ActNorm) or norm.num_channels != 2:
            return None
        if not isinstance(coup, MixLogAttnCoupling) or len(coup.dims) != 1:
            return None
        if coup.odd != (i % 2 != 0) or coup.out_chs != 1:
            return None
        net = coup.net
        if not isinstance(net, Sequential) or len(net.layers) != 6:
            return None
        l0, gl, ln1, at, ln2, lh = net.layers
        if not (isinstance(l0, Dense) and not l0.weight_norm
                and isinstance(gl, GatedLinear)
                and isinstance(ln1, LayerNormNet) and ln1.shape == (l0.out_features,)
                and isinstance(at, GatedAttn) and at.in_shape == (l0.out_features,)
                and at.channels == at.filters == l0.out_features
                and isinstance(ln2, LayerNormNet) and ln2.shape == (l0.out_features,)
                and isinstance(lh, Dense) and not lh.weight_norm):
            return None
        f, k = l0.out_features, coup.n_mixtures
        if l0.in_features != 1 or gl.features != f \
                or lh.in_features != f or lh.out_features != 2 + 3 * k:
            return None
        if F is None:
            F, K = f, k
        elif (F, K) != (f, k):
            return None
    if F > 128 or K > 32:
        return None
    return FlowppSpec(kind="flowpp", n_repeats=n, dim=2, filters=F, n_mixtures=K)


# --------------------------------------------------------------------------
# host-side packing, once per stack
# --------------------------------------------------------------------------
def _stacked(tensors):
    return torch.stack([t.detach() for t in tensors])


@torch.no_grad()
def pack_flowpp(chain, spec: FlowppSpec):
    """Returns (packed, const_ld), ``nf_tpu``'s keys and layout; packed[parity]
    holds (m = n / 2):
      pre  (m, 2, 2)    ActNorm forward (bias, exp(-log_scale))
      prei (m, 2, 2)    ActNorm inverse (bias, exp(log_scale))
      W0   (m, F, 1)    in-projection (out, in)
      W1   (m, F, 2F)   GatedLinear op (out, in)
      Wq   (m, F, F)    attention Q projection (out, in)
      Wo   (m, 2F, F)   attention out projection (out, in)
      Wh   (m, 2+3K, F) head (out, in)
      bh   (m, 2+3K, 1) head bias
      VEC  (m, F, 7)    b0 b1 ln1.gamma ln1.beta bq_eff ln2.gamma ln2.beta
      bo   (m, 2F, 1)   out-projection bias
      gb   (m, 2)       (a_log_scale, a_bias)
    ``bq_eff = Wq pos_emb + b_q`` folds the positional embedding through
    the Q projection.  const_ld is the forward ActNorm constant."""
    layers = chain.layers
    n, F = spec.n_repeats, spec.filters
    const_ld = torch.zeros((), dtype=torch.float32, device=layers[0].bias.device)
    packed = []
    for parity in range(2):
        idxs = range(parity, n, 2)
        b = {}
        norms = [layers[2 * i] for i in idxs]
        log_scale = _stacked([l.log_scale for l in norms])            # (m, 2)
        bias = _stacked([l.bias for l in norms])
        scale = torch.exp(-log_scale)
        b["pre"] = torch.stack([bias, scale], dim=2)
        b["prei"] = torch.stack([bias, 1.0 / scale], dim=2)
        const_ld = const_ld - torch.sum(log_scale)

        coups = [layers[2 * i + 1] for i in idxs]
        nets = [c.net.layers for c in coups]
        d0 = [l[0] for l in nets]
        gl = [l[1].op for l in nets]
        at = [l[3] for l in nets]
        lh = [l[5] for l in nets]
        wq = _stacked([a.w_qkv for a in at])[:, :, 2 * F:3 * F]       # (m, C, F)
        b["W0"] = _stacked([d.w for d in d0])
        b["W1"] = _stacked([g.w for g in gl])
        b["Wq"] = wq.transpose(1, 2)
        bq_eff = (torch.einsum("mcf,mc->mf", wq, _stacked([a.pos_emb for a in at]))
                  + _stacked([a.b_qkv for a in at])[:, 2 * F:3 * F])
        b["Wo"] = _stacked([a.w_out for a in at]).transpose(1, 2)
        b["bo"] = _stacked([a.b_out for a in at])[..., None]
        b["Wh"] = _stacked([l.w for l in lh])
        b["bh"] = _stacked([l.b for l in lh])[..., None]
        b["VEC"] = torch.stack([
            _stacked([d.b for d in d0]), _stacked([g.b for g in gl]),
            _stacked([l[2].gamma for l in nets]), _stacked([l[2].beta for l in nets]),
            bq_eff,
            _stacked([l[4].gamma for l in nets]), _stacked([l[4].beta for l in nets]),
        ], dim=2)
        b["gb"] = torch.cat([_stacked([c.a_log_scale for c in coups]),
                             _stacked([c.a_bias for c in coups])], dim=1)
        packed.append(b)
    return packed, const_ld


# --------------------------------------------------------------------------
# plain PyTorch version, (B, 2) layout
# --------------------------------------------------------------------------
def _layernorm(h, g, b):
    mu = h.mean(dim=1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=1, keepdim=True)
    return (h - mu) * torch.rsqrt(var + LN_EPS) * g + b


def _conditioner(P, j, z1):
    """z1 (B,) -> raw (B, 2 + 3K), eval mode."""
    V = P["VEC"][j]                                               # (F, 7)
    F = V.shape[0]
    h = z1[:, None] * P["W0"][j][:, 0] + V[:, 0]
    u = torch.cat([Fn.elu(h), Fn.elu(-h)], dim=1) @ P["W1"][j].T + V[:, 1]
    h = _layernorm(h + Fn.elu(u) * torch.sigmoid(Fn.elu(-u)), V[:, 2], V[:, 3])
    A = h @ P["Wq"][j].T + V[:, 4]
    y = A @ P["Wo"][j].T + P["bo"][j, :, 0]
    h = _layernorm(h + y[:, :F] * torch.sigmoid(y[:, F:]), V[:, 5], V[:, 6])
    return h @ P["Wh"][j].T + P["bh"][j, :, 0]


def _head(raw, K, gb):
    a = torch.tanh(raw[:, 0]) * gb[0] + gb[1]
    logpi = torch.log_softmax(raw[:, 2:2 + K], dim=1)
    return a, raw[:, 1], logpi, raw[:, 2 + K:2 + 2 * K], raw[:, 2 + 2 * K:2 + 3 * K]


def _layer(P, j, odd, x, ld, inverse):
    r0, r1 = (1, 0) if odd else (0, 1)
    if not inverse:
        pre = P["pre"][j]
        x = (x - pre[:, 0]) * pre[:, 1]
    K = (P["Wh"].shape[1] - 2) // 3
    a, b, logpi, mu, s = _head(_conditioner(P, j, x[:, r1]), K, P["gb"][j])
    x = x.clone()
    if inverse:
        t = (x[:, r0] - b) * torch.exp(-a)
        z, ld_mix = mix_log_cdf_logit_inverse(t, logpi, mu, s)
        x[:, r0] = z
        ld = (ld - a) + ld_mix
        prei = P["prei"][j]
        x = x * prei[:, 1] + prei[:, 0]
    else:
        w, ld_mix = mix_log_cdf_logit_forward(x[:, r0], logpi, mu, s)
        x[:, r0] = w * torch.exp(a) + b
        ld = ld + (ld_mix + a)
    return x, ld


def _is_inverse(direction: str) -> bool:
    if direction not in ("forward", "inverse"):
        raise ValueError(f"direction must be 'forward' or 'inverse', got {direction!r}")
    return direction == "inverse"


def fused_flowpp_reference(packed, const_ld, x, direction: str):
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
# the kernel's layout and its wrapper
# --------------------------------------------------------------------------
def padded_width(filters: int) -> int:
    return min(fp for fp in WIDTHS if fp >= filters)


def padded_mixtures(k: int) -> int:
    return min(kp for kp in MIXTURES if kp >= k)


def _align4(v: int) -> int:
    return (v + 3) // 4 * 4


@dataclass(frozen=True)
class Layout:
    """Offsets (floats) inside one coupling's weight block; the kernel's
    ``Layout`` computes the same.  Rows are (out, in), zero-padded:
      w1 [FP][2FP]   inputs elu(h) in [0, FP), elu(-h) in [FP, 2FP)
      wq [FP][FP]
      wo [2FP][FP]   value rows in [0, FP), gate rows in [FP, 2FP)
      wh [HP][FP]    a, b, logpi [KP], mu [KP], s [KP], padded to HP
      vec: w0 b0 b1 g1 be1 bq g2 be2 [FP each], bo [2FP], bh [HP]"""
    fp: int
    kp: int

    @property
    def hp(self) -> int:
        return _align4(2 + 3 * self.kp)

    @property
    def wq(self) -> int:
        return 2 * self.fp * self.fp

    @property
    def wo(self) -> int:
        return 3 * self.fp * self.fp

    @property
    def wh(self) -> int:
        return 5 * self.fp * self.fp

    @property
    def vec(self) -> int:
        return self.wh + self.hp * self.fp

    @property
    def bo(self) -> int:
        return self.vec + 8 * self.fp

    @property
    def bh(self) -> int:
        return self.bo + 2 * self.fp

    @property
    def size(self) -> int:
        return self.bh + self.hp


def smem_bytes(fp: int, kp: int, staged: bool) -> int:
    """Dynamic shared memory of one block; the kernel computes the same:
    each sample's row of 3 FP + 4 floats (two buffers of the conditioner's
    vectors) and, when staged, two coupling blocks with every matrix row
    padded by 4 floats."""
    lay = Layout(fp, kp)
    rows = SAMPLES * (3 * fp + 4)
    padded = lay.size + 4 * (4 * fp + lay.hp)
    return 4 * (rows + (2 * padded if staged else 0))


def staged(fp: int, kp: int) -> bool:
    """Whether a block stages each coupling's weights in shared memory
    (double-buffered); the widest stacks read them through L2 instead."""
    return smem_bytes(fp, kp, True) <= SMEM_LIMIT


@dataclass(frozen=True)
class KernelWeights:
    """Per coupling c = 2*j + parity: w (n, Layout.size), pre / prei
    (n, 2, 2), gb (n, 2)."""
    fp: int
    kp: int
    w: torch.Tensor
    pre: torch.Tensor
    prei: torch.Tensor
    gb: torch.Tensor


@torch.no_grad()
def kernel_weights(spec: FlowppSpec, packed) -> KernelWeights:
    n, F, K = spec.n_repeats, spec.filters, spec.n_mixtures
    fp, kp = padded_width(F), padded_mixtures(K)
    lay = Layout(fp, kp)
    kw = dict(dtype=torch.float32, device=packed[0]["gb"].device)
    w = torch.zeros(n, lay.size, **kw)
    pre, prei, gb = (torch.zeros(n, 2, 2, **kw), torch.zeros(n, 2, 2, **kw),
                     torch.zeros(n, 2, **kw))

    def block(off, rows, cols):
        return w[:, off:off + rows * cols].view(n, rows, cols)

    # head rows of nf_tpu's layout -> the kernel's padded rows
    head_rows = ([0, 1] + [2 + k for k in range(K)] + [2 + kp + k for k in range(K)]
                 + [2 + 2 * kp + k for k in range(K)])
    for parity in range(2):
        P = packed[parity]
        c = slice(parity, n, 2)
        pre[c], prei[c], gb[c] = P["pre"], P["prei"], P["gb"]
        w1 = block(0, fp, 2 * fp)
        w1[c, :F, :F] = P["W1"][:, :, :F]
        w1[c, :F, fp:fp + F] = P["W1"][:, :, F:]
        block(lay.wq, fp, fp)[c, :F, :F] = P["Wq"]
        wo = block(lay.wo, 2 * fp, fp)
        wo[c, :F, :F] = P["Wo"][:, :F]
        wo[c, fp:fp + F, :F] = P["Wo"][:, F:]
        block(lay.wh, lay.hp, fp)[c, head_rows, :F] = P["Wh"]
        vec = block(lay.vec, 8, fp)
        vec[c, 0, :F] = P["W0"][:, :, 0]
        vec[c, 1:, :F] = P["VEC"].transpose(1, 2)
        bo = block(lay.bo, 2, fp)
        bo[c, 0, :F] = P["bo"][:, :F, 0]
        bo[c, 1, :F] = P["bo"][:, F:, 0]
        block(lay.bh, 1, lay.hp)[c, 0, head_rows] = P["bh"][:, :, 0]
    return KernelWeights(fp=fp, kp=kp, w=w, pre=pre, prei=prei, gb=gb)


class PackedFlowpp:
    """One stack's packed weights, built once: ``nf_tpu``'s layout for the
    plain version and, for a stack on the card, the kernel's layout."""

    def __init__(self, spec: FlowppSpec, packed, const_ld: torch.Tensor):
        self.spec = spec
        self.packed = packed
        self.const_ld = const_ld
        self.device = const_ld.device
        self.kernel = (kernel_weights(spec, packed)
                       if const_ld.device.type == "cuda" else None)
        self.ld_const = float(const_ld) if self.kernel is not None else None


def _kernel_fn():
    fn = _build.load("fused_flowpp").nf_fused_flowpp
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def launch(stack: PackedFlowpp, x: torch.Tensor, inverse: bool):
    """Launch the CUDA kernel on ``x`` (B, 2): returns (y, logdet (B,))."""
    with span(SPANS[inverse]):
        return _launch(stack, x, inverse)


def _launch(stack: PackedFlowpp, x: torch.Tensor, inverse: bool):
    kw, spec = stack.kernel, stack.spec
    if not x.is_cuda:
        raise ValueError(f"fused_flowpp kernel needs a CUDA tensor, got {x.device}")
    if kw is None or kw.w.device != x.device:
        raise ValueError(f"fused_flowpp: weights on {stack.device}, x on {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 2 \
            or not x.is_contiguous():
        raise ValueError("fused_flowpp kernel takes a contiguous float32 (B, 2) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    y = torch.empty_like(x)
    ld = torch.empty(B, dtype=torch.float32, device=x.device)
    if B == 0:
        return y, ld
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), ld.data_ptr(), kw.w.data_ptr(),
                 (kw.prei if inverse else kw.pre).data_ptr(), kw.gb.data_ptr(),
                 B, spec.n_repeats, spec.filters, spec.n_mixtures, kw.fp, kw.kp,
                 int(staged(kw.fp, kw.kp)), int(inverse),
                 -stack.ld_const if inverse else stack.ld_const,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_flowpp {'inverse' if inverse else 'forward'} "
                           f"kernel failed to launch: CUDA error {err}")
    LAUNCHES["fused_flowpp_inv" if inverse else "fused_flowpp_fwd"] += 1
    return y, ld


def fused_flowpp(stack: PackedFlowpp, x: torch.Tensor, direction: str):
    """Eval-mode forward or inverse of the whole stack: (y, logdet (B,)).

    CPU tensors take the plain version; any other tensor launches the
    kernel or raises."""
    inverse = _is_inverse(direction)
    if x.device.type == "cpu":
        return fused_flowpp_reference(stack.packed, stack.const_ld, x, direction)
    return launch(stack, x, inverse)
