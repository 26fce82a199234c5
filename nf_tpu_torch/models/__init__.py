"""Model zoo registry (counterpart of ``nf_tpu/models/__init__.py``);
``build_model`` is the single construction entry point."""
from __future__ import annotations

import torch

from ..config import NETWORK_DEFAULTS, NetworkConfig
from ..ops.precision import PRECISIONS, set_matmul_precision
from .base import EvalProgram, FlowModel  # noqa: F401
from .ffjord import build_ffjord
from .flowpp import build_flowpp
from .glow import build_glow
from .maf import build_maf
from .planar import build_planar
from .realnvp import build_realnvp
from .resflow import build_resflow

_REGISTRY = {
    "planar": build_planar,
    "realnvp": build_realnvp,
    "glow": build_glow,
    "flow++": build_flowpp,
    "maf": build_maf,
    "resflow": build_resflow,
    "ffjord": build_ffjord,
}


def register(name, builder):
    """Add (or replace) ``name``'s builder: ``builder(dims, datatype=...,
    cfg=..., device=...)`` returns a ``FlowModel``.  ``build_model`` hands
    it the ``cfg`` it was given, which is None, as in ``nf_tpu``, for a name
    without ``NETWORK_DEFAULTS``."""
    _REGISTRY[name] = builder


def available_models():
    return sorted(_REGISTRY)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, raise rather than
    quietly run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("nf_tpu_torch runs on the CUDA card by default "
                               "and none is available; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _apply_matmul_precision(cfg, device: torch.device):
    """Set the f32 matmul / conv precision of the models' library products
    for this process (``ops/precision.py``), as ``nf_tpu`` sets XLA's
    default; the last model built sets it for every model.  ``None`` (the
    port's default: ``nf_tpu``'s automatic bf16 applies on a TPU only),
    "float32" and "highest" run full f32; "bfloat16" gives the products
    bf16-rounded operands with f32 sums on the card.  The card's own
    defaults are turned off for everything else: TF32 for cuBLAS and
    cuDNN, whose own default is TF32 on for convolutions.  The CPU
    computes f32 whatever is asked, as XLA on the CPU does."""
    p = getattr(cfg, "matmul_precision", None)
    if p not in PRECISIONS:
        raise ValueError(f"unknown matmul_precision {p!r}")
    set_matmul_precision(p)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def build_model(name: str, dims, datatype=None, cfg=None,
                device=None) -> FlowModel:
    if name not in _REGISTRY:
        raise ValueError(f"unknown network {name!r}; available: {available_models()}")
    if cfg is None and name in NETWORK_DEFAULTS:
        cfg = NetworkConfig(name=name, **NETWORK_DEFAULTS[name])
    device = resolve_device(device)
    _apply_matmul_precision(cfg, device)
    return _REGISTRY[name](dims, datatype=datatype, cfg=cfg, device=device)
