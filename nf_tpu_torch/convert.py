"""Carry ``nf_tpu`` variables across into the port's modules, and back.

``nf_tpu`` keeps a model's variables as a ``{'params', 'state'}`` pytree
(``nf_tpu/core/bijector.py`` ``Variables``): nested lists for ``Chain`` /
``Sequential`` children and dicts inside each layer, ``{}`` for a layer
without variables.  ``variable_tree`` builds that tree for a module with a
``Leaf`` (the port's tensor and how it maps to ``nf_tpu``'s array) at each
leaf; ``load_jax_variables`` takes the pytree with numpy arrays as leaves
and copies it into the matching parameters and buffers, and
``export_jax_variables`` writes it back, its exact inverse (``nf_tpu``'s
nesting, layouts and dtypes).  A ``ScannedChain``'s variables are its
blocks' stacked on a leading block axis, as ``nf_tpu`` stacks them: slice
i is block i.  Layout differences handled here:

* ``Dense`` weights are ``(in, out)`` in ``nf_tpu`` and ``(out, in)`` here,
  so ``v`` / ``w`` are transposed; ``g`` stays per input feature.
* ``Conv2d`` kernels are HWIO ``(kh, kw, in, out)`` there and
  ``(out, in, kh, kw)`` here; ``g`` is ``(kh, kw, in)`` there and
  ``(in, kh, kw)`` here.  ``ResBlock2d`` nests ``net`` / ``bridge`` as
  ``ResBlockLinear`` does, and ``ConvNet`` is a ``Sequential``.
* ``Logit``, ``Squeeze1d``, ``Unsqueeze1d``, ``Squeeze2d`` and
  ``Unsqueeze2d`` have no variables.
* A non-affine flow ``BatchNorm`` keeps ``log_gamma`` / ``beta`` in state,
  here as buffers.
* ``ActNorm``'s ``initialized`` flag (bool), and ``InvertibleConv1x1``'s
  ``P`` and ``sign_s``, are state there and buffers here.  ``L`` arrives whole from
  the LU factorization; only its strict lower part counts.
* ``GatedLinear`` and ``GatedConv2d`` nest their dense or conv layer (no
  weight norm) under ``"op"``.  ``GatedAttn`` keeps ``nf_tpu``'s
  ``(in, out)`` layout for its raw projections, so they copy as they are.
* ``SpectralNormDense`` keeps ``nf_tpu``'s ``(in, out)`` ``w_bar`` and
  ``SpectralNormConv2d`` its HWIO ``w_bar``; their power-iteration vectors
  ``u`` / ``v`` (NHWC featuremaps for a conv with ``spatial``, vectors
  otherwise) are state there and buffers here, all copied as they are.
  ``InvertibleResBlock`` nests its g-net under ``"g"`` in both trees.
* ``MADE`` keeps lists ``w`` / ``u`` / ``b`` / ``bn`` and its masks in
  state, ``(in, out)`` there and ``(out, in)`` here (both transposed);
  ``AutoregressiveTransform`` nests the MADEs under ``"s"`` / ``"t"`` and
  keeps ``perm`` in state (int32 there, int64 here).  ``PlanarTransform``'s ``u`` / ``w`` / ``b``
  copy as they are; ``Flatten`` has no variables, and ``Inverted`` and
  ``CheckedBijector`` hold their inner bijector's, with no level of their
  own (``nf_tpu``'s ``CheckedBijector.init`` returns the inner's).
* ``CNF`` keeps its ODENet under ``{'net': {'w': [...], 'b': [...]}}`` and
  its time grid in state (``times``, a buffer here).  Dense weights keep
  ``nf_tpu``'s ``(din + 1, dout)`` and copy as they are; conv weights are
  HWIO there and ``(out, in, kh, kw)`` here.
* ``VariationalDequant`` nests its ``ConvNet``s under ``affine`` and
  ``couplings[0..1]`` in both trees.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .bijectors.cnf import CNF
from .bijectors.conv1x1 import InvertibleConv1x1
from .bijectors.coupling import AdditiveCoupling, AffineCoupling
from .bijectors.elementwise import Arctanh, Identity, Logit, Sigmoid, Tanh
from .bijectors.flowpp_coupling import MixLogAttnCoupling
from .bijectors.iresblock import InvertibleResBlock
from .bijectors.made import MADE, AutoregressiveTransform
from .bijectors.norm import ActNorm, BatchNorm
from .bijectors.planar import PlanarTransform
from .bijectors.squeeze import Flatten, Squeeze1d, Squeeze2d, Unsqueeze1d, Unsqueeze2d
from .bijectors.vardequant import VariationalDequant
from .core.bijector import Chain, Inverted, ScannedChain
from .models.base import FlowModel
from .nets.conditioners import ResBlockLinear
from .nets.core import Activation, Sequential
from .nets.gated import GatedAttn, GatedConv2d, GatedLinear, LayerNormNet
from .nets.layers import BatchNormNet, Conv2d, Dense
from .nets.spectral import LipSwish, SpectralNormConv2d, SpectralNormDense
from .utils.debug import CheckedBijector

T = (1, 0)              # (out, in) -> (in, out)
HWIO = (2, 3, 1, 0)     # (out, in, kh, kw) -> (kh, kw, in, out)
KKI = (1, 2, 0)         # a conv's weight-norm g: (in, kh, kw) -> (kh, kw, in)


class Leaf:
    """One ``nf_tpu`` array: the port's tensors (one per block along
    ``stack``, the leading block axes of a ``ScannedChain``), the axis
    order ``perm`` that takes a tensor to ``nf_tpu``'s layout, and
    ``nf_tpu``'s dtype."""

    def __init__(self, tensors: Sequence[torch.Tensor], perm=None, dtype=np.float32,
                 stack=()):
        self.tensors = list(tensors)
        self.perm = perm
        self.dtype = np.dtype(dtype)
        self.stack = tuple(stack)

    @property
    def shape(self):
        s = tuple(self.tensors[0].shape)
        return self.stack + (s if self.perm is None else tuple(s[i] for i in self.perm))

    def with_tensors(self, tensors) -> "Leaf":
        """The same layout over other tensors (e.g. the optimizer's
        moments of these parameters)."""
        return Leaf(tensors, self.perm, self.dtype, self.stack)

    def to_jax(self) -> np.ndarray:
        arrays = []
        for t in self.tensors:
            a = t.detach().cpu().numpy()
            arrays.append(a if self.perm is None else a.transpose(self.perm))
        a = np.stack(arrays).reshape(self.shape) if self.stack else arrays[0]
        return np.array(a, dtype=self.dtype, order="C")

    def load(self, a, name: str) -> None:
        a = np.asarray(a)
        if a.shape != self.shape:
            raise ValueError(f"{name}: shape {a.shape} does not fit {self.shape}")
        parts = a.reshape((-1,) + a.shape[len(self.stack):]) if self.stack else [a]
        for t, part in zip(self.tensors, parts):
            if self.perm is not None:
                part = part.transpose(np.argsort(self.perm))
            t.copy_(torch.from_numpy(np.array(part, order="C")))


def _leaf(t, perm=None, dtype=np.float32) -> Leaf:
    return Leaf([t], perm, dtype)


def _vars(params, state) -> dict:
    return {"params": params, "state": state}


def _sub(**children) -> dict:
    """``{'params': {k: child's params}, 'state': {k: child's state}}``."""
    return _vars({k: v["params"] for k, v in children.items()},
                 {k: v["state"] for k, v in children.items()})


def _seq(nodes) -> dict:
    nodes = list(nodes)
    return _vars([n["params"] for n in nodes], [n["state"] for n in nodes])


def _named(module, names, **kw) -> dict:
    return {k: _leaf(getattr(module, k), **kw) for k in names}


def stack_trees(trees: List, name: str = "blocks"):
    """Trees of one structure as one tree of stacked leaves."""
    first = trees[0]
    if isinstance(first, Leaf):
        for t in trees[1:]:
            if not isinstance(t, Leaf) or t.shape != first.shape or t.perm != first.perm:
                raise ValueError(f"{name}: blocks differ in their variables")
        return Leaf([x for t in trees for x in t.tensors], first.perm, first.dtype,
                    (len(trees),) + first.stack)
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or t.keys() != first.keys() for t in trees):
            raise ValueError(f"{name}: blocks differ in their variables")
        return {k: stack_trees([t[k] for t in trees], f"{name}.{k}") for k in first}
    if any(not isinstance(t, list) or len(t) != len(first) for t in trees):
        raise ValueError(f"{name}: blocks differ in their variables")
    return [stack_trees([t[i] for t in trees], f"{name}[{i}]") for i in range(len(first))]


def _made(m) -> dict:
    params = {"w": [_leaf(w, T) for w in m.w], "b": [_leaf(b) for b in m.b],
              "bn": [variable_tree(bn)["params"] for bn in m.bn]}
    if m.u is not None:
        params["u"] = [_leaf(u, T) for u in m.u]
    return _vars(params, {"masks": [_leaf(k, T) for k in m.masks()],
                          "bn": [variable_tree(bn)["state"] for bn in m.bn]})


_NO_VARIABLES = (Activation, Logit, Squeeze1d, Unsqueeze1d, Squeeze2d, Unsqueeze2d, Flatten,
                 Identity, Sigmoid, Tanh, Arctanh)


def variable_tree(module) -> dict:
    """``module``'s ``{'params', 'state'}`` tree in ``nf_tpu``'s structure
    with a ``Leaf`` at every leaf."""
    m = module
    if isinstance(m, FlowModel):
        return variable_tree(m.bijector)
    if isinstance(m, (Chain, Sequential)):
        return _seq(variable_tree(layer) for layer in m.layers)
    if isinstance(m, ScannedChain):
        return stack_trees([variable_tree(b) for b in m.blocks], type(m).__name__)
    if isinstance(m, _NO_VARIABLES):
        return _vars({}, {})
    if isinstance(m, (Inverted, CheckedBijector)):
        return variable_tree(m.inner)
    if isinstance(m, Dense):
        p = ({"g": _leaf(m.g), "v": _leaf(m.v, T)} if m.weight_norm else {"w": _leaf(m.w, T)})
        return _vars({**p, "b": _leaf(m.b)}, {})
    if isinstance(m, Conv2d):
        p = ({"g": _leaf(m.g, KKI), "v": _leaf(m.v, HWIO)} if m.weight_norm
             else {"w": _leaf(m.w, HWIO)})
        return _vars({**p, "b": _leaf(m.b)}, {})
    if isinstance(m, BatchNormNet):
        return _vars(_named(m, ("gamma", "beta")), _named(m, ("running_mean", "running_var")))
    if isinstance(m, ResBlockLinear):
        kids = {"net": variable_tree(m.net)}
        if m.bridge is not None:
            kids["bridge"] = variable_tree(m.bridge)
        return _sub(**kids)
    if isinstance(m, BatchNorm):
        affine = _named(m, ("log_gamma", "beta"))
        stats = _named(m, ("running_mean", "running_var", "batch_mean", "batch_var"))
        return _vars(affine, stats) if m.affine else _vars({}, {**stats, **affine})
    if isinstance(m, (AffineCoupling, AdditiveCoupling, MixLogAttnCoupling)):
        node = _sub(net=variable_tree(m.net))
        scalars = {AffineCoupling: ("s_log_scale", "s_bias"), AdditiveCoupling: (),
                   MixLogAttnCoupling: ("a_log_scale", "a_bias")}[type(m)]
        node["params"].update(_named(m, scalars))
        return node
    if isinstance(m, ActNorm):
        return _vars(_named(m, ("log_scale", "bias")),
                     {"initialized": _leaf(m.initialized, dtype=np.bool_)})
    if isinstance(m, InvertibleConv1x1):
        return _vars(_named(m, ("L", "U", "log_s")), _named(m, ("P", "sign_s")))
    if isinstance(m, (GatedLinear, GatedConv2d)):
        return _vars({"op": variable_tree(m.op)["params"]}, {})
    if isinstance(m, LayerNormNet):
        return _vars(_named(m, ("gamma", "beta")), {})
    if isinstance(m, GatedAttn):
        return _vars(_named(m, ("w_qkv", "b_qkv", "w_out", "b_out", "pos_emb")), {})
    if isinstance(m, (SpectralNormDense, SpectralNormConv2d)):
        return _vars(_named(m, ("w_bar", "b")), _named(m, ("u", "v")))
    if isinstance(m, LipSwish):
        return _vars(_named(m, ("beta",)), {})
    if isinstance(m, InvertibleResBlock):
        return _sub(g=variable_tree(m.g_net))
    if isinstance(m, MADE):
        return _made(m)
    if isinstance(m, AutoregressiveTransform):
        node = _sub(s=variable_tree(m.net_s), t=variable_tree(m.net_t))
        node["params"].update(_named(m, ("s_log_scale", "s_bias")))
        node["state"]["perm"] = _leaf(m.perm, dtype=np.int32)
        return node
    if isinstance(m, PlanarTransform):
        return _vars(_named(m, ("u", "w", "b")), {})
    if isinstance(m, CNF):
        conv = HWIO if m.net.is_image else None
        return _vars({"net": {"w": [_leaf(w, conv) for w in m.net.w],
                              "b": [_leaf(b) for b in m.net.b]}},
                     {"times": _leaf(m.times)})
    if isinstance(m, VariationalDequant):
        return _sub(affine=variable_tree(m.net_affine),
                    couplings=_seq(variable_tree(n) for n in m.net_couplings))
    raise TypeError(f"no conversion for {type(m).__name__}")


def leaves(tree, path: str = ""):
    """(keystr, leaf) pairs in ``jax.tree_util``'s flatten order: dict keys
    sorted, sequences and NamedTuple fields in order, empty containers
    and None giving nothing; the path as ``jax.tree_util.keystr``
    writes it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from leaves(t, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def tree_map(fn, tree, *others, name: str = "variables"):
    """``fn(leaf, *other leaves, name)`` over ``tree``'s leaves; every
    other tree must have ``tree``'s structure."""
    if isinstance(tree, Leaf):
        return fn(tree, *others, name)
    if isinstance(tree, dict):
        for o in others:
            if not isinstance(o, dict) or set(o) != set(tree):
                got = sorted(o) if isinstance(o, dict) else type(o).__name__
                raise ValueError(f"{name}: keys {got} for {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in others), name=f"{name}.{k}")
                for k in tree}
    for o in others:
        if not isinstance(o, (list, tuple)) or len(o) != len(tree):
            got = len(o) if isinstance(o, (list, tuple)) else type(o).__name__
            raise ValueError(f"{name}: {got} entries for {len(tree)}")
    return [tree_map(fn, t, *(o[i] for o in others), name=f"{name}[{i}]")
            for i, t in enumerate(tree)]


@torch.no_grad()
def load_jax_variables(module, var) -> dict:
    """Copy an ``nf_tpu`` ``{'params', 'state'}`` pytree (numpy leaves) into
    ``module``; returns its state dict.  A ``ScannedChain``'s stacked
    leaves go slice by slice into its blocks."""
    tree = variable_tree(module)
    for kind in ("params", "state"):
        tree_map(lambda leaf, a, name: leaf.load(a, name), tree[kind], var[kind],
                 name=f"{type(module).__name__}.{kind}")
    return module.state_dict()


def export_jax_variables(module) -> dict:
    """``module``'s variables as ``nf_tpu``'s ``{'params', 'state'}``
    pytree of numpy arrays: the inverse of ``load_jax_variables``."""
    tree = variable_tree(module)
    return {kind: tree_map(lambda leaf, name: leaf.to_jax(), tree[kind])
            for kind in ("params", "state")}
