"""Model zoo registry (counterpart of ``nf_tpu/models/__init__.py``);
``build_model`` is the single construction entry point."""
from __future__ import annotations

import torch

from ..config import NETWORK_DEFAULTS, NetworkConfig
from .base import EvalProgram, FlowModel  # noqa: F401
from .flowpp import build_flowpp
from .glow import build_glow
from .realnvp import build_realnvp
from .resflow import build_resflow

_REGISTRY = {
    "realnvp": build_realnvp,
    "glow": build_glow,
    "flow++": build_flowpp,
    "resflow": build_resflow,
}


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


def build_model(name: str, dims, datatype=None, cfg=None,
                device=None) -> FlowModel:
    if name not in _REGISTRY:
        raise ValueError(f"unknown network {name!r}; available: {available_models()}")
    if cfg is None:
        cfg = NetworkConfig(name=name, **NETWORK_DEFAULTS[name])
    device = resolve_device(device)
    return _REGISTRY[name](dims, datatype=datatype, cfg=cfg, device=device)
