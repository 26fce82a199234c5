"""Model zoo registry (counterpart of ``nf_tpu/models/__init__.py``);
``build_model`` is the single construction entry point."""
from __future__ import annotations

import torch

from ..config import NETWORK_DEFAULTS, NetworkConfig
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
    """Set the card's f32 matmul / conv precision for this process, as
    ``nf_tpu`` sets XLA's default.  ``None``, "float32" and "highest" run
    full f32: TF32 off for cuBLAS and for cuDNN, whose own default is TF32
    on for convolutions.  "bfloat16" is not ported: it raises on the card
    (the CPU computes f32 whatever is asked, as XLA on the CPU does)."""
    p = getattr(cfg, "matmul_precision", None)
    if p not in (None, "float32", "highest", "bfloat16"):
        raise ValueError(f"unknown matmul_precision {p!r}")
    if device.type != "cuda":
        return
    if p == "bfloat16":
        raise NotImplementedError("matmul_precision='bfloat16' is not ported yet: "
                                  "no measurement on the card backs it")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_model(name: str, dims, datatype=None, cfg=None,
                device=None) -> FlowModel:
    if name not in _REGISTRY:
        raise ValueError(f"unknown network {name!r}; available: {available_models()}")
    if cfg is None:
        cfg = NetworkConfig(name=name, **NETWORK_DEFAULTS[name])
    if getattr(cfg, "compute_dtype", "float32") not in (None, "float32"):
        raise NotImplementedError(f"compute_dtype={cfg.compute_dtype!r} is not ported "
                                  "yet; the port computes in float32")
    for flag in ("scan", "remat"):     # nf_tpu's ScannedChain and rematerialization
        if getattr(cfg, flag, False):
            raise NotImplementedError(f"{name} with {flag}=True is not ported yet")
    device = resolve_device(device)
    _apply_matmul_precision(cfg, device)
    return _REGISTRY[name](dims, datatype=datatype, cfg=cfg, device=device)
