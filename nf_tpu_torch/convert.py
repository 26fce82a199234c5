"""Carry ``nf_tpu`` variables across into the port's modules.

``nf_tpu`` keeps a model's variables as a ``{'params', 'state'}`` pytree
(``nf_tpu/core/bijector.py`` ``Variables``): nested lists for ``Chain`` /
``Sequential`` children and dicts inside each layer.  ``load_jax_variables``
takes that pytree with numpy arrays as leaves and copies it into the
matching parameters and buffers.  Layout differences handled here:

* ``Dense`` weights are ``(in, out)`` in ``nf_tpu`` and ``(out, in)`` here,
  so ``v`` / ``w`` are transposed; ``g`` stays per input feature.
* ``Conv2d`` kernels are HWIO ``(kh, kw, in, out)`` there and
  ``(out, in, kh, kw)`` here; ``g`` is ``(kh, kw, in)`` there and
  ``(in, kh, kw)`` here.  ``ResBlock2d`` nests ``net`` / ``bridge`` as
  ``ResBlockLinear`` does, and ``ConvNet`` is a ``Sequential``.
* ``Logit``, ``Squeeze2d`` and ``Unsqueeze2d`` have no variables.
* A non-affine flow ``BatchNorm`` keeps ``log_gamma`` / ``beta`` in state,
  here as buffers.
* ``ActNorm``'s ``initialized`` flag, and ``InvertibleConv1x1``'s ``P`` and
  ``sign_s``, are state there and buffers here.  ``L`` arrives whole from
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
  keeps ``perm`` in state.  ``PlanarTransform``'s ``u`` / ``w`` / ``b``
  copy as they are; ``Flatten`` has no variables, and ``Inverted`` holds
  its inner bijector's.
* ``CNF`` keeps its ODENet under ``{'net': {'w': [...], 'b': [...]}}`` and
  its time grid in state (``times``, a buffer here).  Dense weights keep
  ``nf_tpu``'s ``(din + 1, dout)`` and copy as they are; conv weights are
  HWIO there and ``(out, in, kh, kw)`` here.
* ``VariationalDequant`` nests its ``ConvNet``s under ``affine`` and
  ``couplings[0..1]`` in both trees.
"""
from __future__ import annotations

import numpy as np
import torch

from .bijectors.cnf import CNF
from .bijectors.conv1x1 import InvertibleConv1x1
from .bijectors.coupling import AffineCoupling
from .bijectors.elementwise import Logit
from .bijectors.flowpp_coupling import MixLogAttnCoupling
from .bijectors.iresblock import InvertibleResBlock
from .bijectors.made import MADE, AutoregressiveTransform
from .bijectors.norm import ActNorm, BatchNorm
from .bijectors.planar import PlanarTransform
from .bijectors.squeeze import Flatten, Squeeze2d, Unsqueeze2d
from .bijectors.vardequant import VariationalDequant
from .core.bijector import Chain, Inverted
from .models.base import FlowModel
from .nets.conditioners import ResBlockLinear
from .nets.core import Activation, Sequential
from .nets.gated import GatedAttn, GatedConv2d, GatedLinear, LayerNormNet
from .nets.layers import BatchNormNet, Conv2d, Dense
from .nets.spectral import LipSwish, SpectralNormConv2d, SpectralNormDense


def _copy(dst: torch.Tensor, src, name: str, transpose=False) -> None:
    """Copy ``src`` into ``dst`` in ``dst``'s dtype; ``transpose`` is True
    (reverse the axes) or an axis order for ``np.transpose``."""
    a = np.asarray(src)
    if transpose is True:
        a = a.T
    elif transpose:
        a = a.transpose(transpose)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {a.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.tensor(a))


def _load_made(module, params, state, path: str) -> None:
    n = len(module.w)
    lists = [("w", module.w), ("b", module.b)] + ([("u", module.u)] if module.u is not None
                                                  else [])
    if "u" in params and module.u is None:
        raise ValueError(f"{path}: companion weights for a MADE without them")
    for k, dst in lists:
        if len(params[k]) != n:
            raise ValueError(f"{path}.{k}: {len(params[k])} entries for {n} layers")
        for i in range(n):
            _copy(dst[i], params[k][i], f"{path}.{k}[{i}]", transpose=k != "b")
    for i, m in enumerate(module.masks()):
        _copy(m, state["masks"][i], f"{path}.masks[{i}]", transpose=True)
    for i, bn in enumerate(module.bn):
        _load(bn, params["bn"][i], state["bn"][i], f"{path}.bn[{i}]")


def _load_cnf(module, params, state, path: str) -> None:
    net = module.net
    hwio = (3, 2, 0, 1) if net.is_image else False
    for k, dst, order in (("w", net.w, hwio), ("b", net.b, False)):
        if len(params["net"][k]) != len(dst):
            raise ValueError(f"{path}.net.{k}: {len(params['net'][k])} entries for "
                             f"{len(dst)} layers")
        for i in range(len(dst)):
            _copy(dst[i], params["net"][k][i], f"{path}.net.{k}[{i}]", transpose=order)
    _copy(module.times, state["times"], f"{path}.times")


def _load(module, params, state, path: str) -> None:
    if isinstance(module, FlowModel):
        _load(module.bijector, params, state, path)
    elif isinstance(module, (Chain, Sequential)):
        layers = module.layers
        if len(params) != len(layers) or len(state) != len(layers):
            raise ValueError(f"{path}: {len(params)} variable entries for "
                             f"{len(layers)} layers")
        for i, layer in enumerate(layers):
            _load(layer, params[i], state[i], f"{path}[{i}]")
    elif isinstance(module, Dense):
        if module.weight_norm:
            _copy(module.g, params["g"], f"{path}.g")
            _copy(module.v, params["v"], f"{path}.v", transpose=True)
        else:
            _copy(module.w, params["w"], f"{path}.w", transpose=True)
        _copy(module.b, params["b"], f"{path}.b")
    elif isinstance(module, Conv2d):
        hwio = (3, 2, 0, 1)
        if module.weight_norm:
            _copy(module.g, params["g"], f"{path}.g", transpose=(2, 0, 1))
            _copy(module.v, params["v"], f"{path}.v", transpose=hwio)
        else:
            _copy(module.w, params["w"], f"{path}.w", transpose=hwio)
        _copy(module.b, params["b"], f"{path}.b")
    elif isinstance(module, BatchNormNet):
        for k in ("gamma", "beta"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
        for k in ("running_mean", "running_var"):
            _copy(getattr(module, k), state[k], f"{path}.{k}")
    elif isinstance(module, ResBlockLinear):
        _load(module.net, params["net"], state["net"], f"{path}.net")
        if module.bridge is not None:
            _load(module.bridge, params["bridge"], state["bridge"],
                  f"{path}.bridge")
    elif isinstance(module, (Activation, Logit, Squeeze2d, Unsqueeze2d, Flatten)):
        pass
    elif isinstance(module, Inverted):
        _load(module.inner, params, state, f"{path}.inner")
    elif isinstance(module, BatchNorm):
        src = params if module.affine else state
        for k in ("log_gamma", "beta"):
            _copy(getattr(module, k), src[k], f"{path}.{k}")
        for k in ("running_mean", "running_var", "batch_mean", "batch_var"):
            _copy(getattr(module, k), state[k], f"{path}.{k}")
    elif isinstance(module, AffineCoupling):
        _load(module.net, params["net"], state["net"], f"{path}.net")
        for k in ("s_log_scale", "s_bias"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
    elif isinstance(module, ActNorm):
        for k in ("log_scale", "bias"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
        module.initialized.fill_(bool(np.asarray(state["initialized"])))
    elif isinstance(module, InvertibleConv1x1):
        for k in ("L", "U", "log_s"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
        for k in ("P", "sign_s"):
            _copy(getattr(module, k), state[k], f"{path}.{k}")
    elif isinstance(module, (GatedLinear, GatedConv2d)):
        _load(module.op, params["op"], {}, f"{path}.op")
    elif isinstance(module, LayerNormNet):
        for k in ("gamma", "beta"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
    elif isinstance(module, GatedAttn):
        for k in ("w_qkv", "b_qkv", "w_out", "b_out", "pos_emb"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
    elif isinstance(module, MixLogAttnCoupling):
        _load(module.net, params["net"], state["net"], f"{path}.net")
        for k in ("a_log_scale", "a_bias"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
    elif isinstance(module, (SpectralNormDense, SpectralNormConv2d)):
        for k in ("w_bar", "b"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
        for k in ("u", "v"):
            _copy(getattr(module, k), state[k], f"{path}.{k}")
    elif isinstance(module, LipSwish):
        _copy(module.beta, params["beta"], f"{path}.beta")
    elif isinstance(module, InvertibleResBlock):
        _load(module.g_net, params["g"], state["g"], f"{path}.g")
    elif isinstance(module, MADE):
        _load_made(module, params, state, path)
    elif isinstance(module, AutoregressiveTransform):
        for k, net in (("s", module.net_s), ("t", module.net_t)):
            _load(net, params[k], state[k], f"{path}.{k}")
        for k in ("s_log_scale", "s_bias"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
        _copy(module.perm, state["perm"], f"{path}.perm")
    elif isinstance(module, PlanarTransform):
        for k in ("u", "w", "b"):
            _copy(getattr(module, k), params[k], f"{path}.{k}")
    elif isinstance(module, CNF):
        _load_cnf(module, params, state, path)
    elif isinstance(module, VariationalDequant):
        _load(module.net_affine, params["affine"], state["affine"], f"{path}.affine")
        for i, net in enumerate(module.net_couplings):
            _load(net, params["couplings"][i], state["couplings"][i],
                  f"{path}.couplings[{i}]")
    else:
        raise TypeError(f"{path}: no conversion for {type(module).__name__}")


@torch.no_grad()
def load_jax_variables(module, var) -> dict:
    """Copy an ``nf_tpu`` ``{'params', 'state'}`` pytree (numpy leaves) into
    ``module``; returns its state dict."""
    _load(module, var["params"], var["state"], type(module).__name__)
    return module.state_dict()
