"""Configuration fields the ported model builders read.

Counterpart of ``nf_tpu/config.py``: the port keeps its own copy of the
``NetworkConfig`` fields that its builders use and of
``OptimizerConfig``, with the same names and defaults, and
``NETWORK_DEFAULTS`` for the ported networks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class NetworkConfig:
    name: str = "realnvp"
    layers: int = 32
    # flow++ mixture components (configs/network/flow++.yaml)
    mixtures: int = 8
    # resflow (configs/network/resflow.yaml)
    logdet: str = "unbias"
    spnorm_coeff: float = 0.9
    # ffjord (configs/network/ffjord.yaml): the time grid t0..t1 at
    # ``stepsize``, the ODE solver (ops/odeint.py SOLVERS), "adjoint" or
    # "normal" backprop, and the trace estimator in eval ("exact" or
    # "hutchinson"; training always takes one Hutchinson probe)
    t0: float = 0.0
    t1: float = 1.0
    stepsize: float = 0.1
    solver: str = "dopri5"
    backprop: str = "adjoint"
    trace: str = "hutchinson"
    # adaptive-solver tolerances; None = the solver tableau's defaults
    rtol: Optional[float] = None
    atol: Optional[float] = None
    # maf and ffjord image mode: the flattened-pixel MAF and the conv
    # ODENet (nf_tpu's opt-ins; image data raises without it)
    allow_image: bool = False
    # flow++ image mode: variational dequantization (a conditional flow
    # over the dequantization noise, trained by the ELBO) before the Logit
    var_dequant: bool = False
    # maf: redraw the MADE masks from the trainer's per-step generator on
    # every training forward; False keeps the masks drawn at init
    resample_masks: bool = False
    # conditioner width (reference MLP/ConvNet base_filters=32)
    base_filters: int = 32
    # matmul / conv precision of the library products: None, "float32" or
    # "highest" run f32 (TF32 off on the card); "bfloat16" takes bf16
    # operands and f32 sums on the card (ops/precision.py), f32 on the CPU
    matmul_precision: Optional[str] = None
    # conditioner compute dtype ("bfloat16": RealNVP's and Glow's coupling
    # nets in bf16, the flow math f32; the other families ignore it)
    compute_dtype: str = "float32"
    # rematerialization (checkpointed layers or scanned blocks) and the
    # scan composition (repeated stages as ScannedChain blocks)
    remat: bool = False
    scan: bool = False


@dataclass
class OptimizerConfig:
    """Counterpart of ``nf_tpu.config.OptimizerConfig``."""
    name: str = "adam"
    lr: float = 1.0e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    decay_steps: int = 10000
    decay_ratio: float = 0.5


# per-network defaults mirroring configs/network/*.yaml
NETWORK_DEFAULTS = {
    "planar": dict(layers=32),
    "realnvp": dict(layers=32),
    "glow": dict(layers=32),
    "flow++": dict(layers=32, mixtures=8),
    "maf": dict(layers=32),
    "resflow": dict(layers=32, logdet="unbias", spnorm_coeff=0.9),
    # rtol / atol 1e-4, nf_tpu's choice for its accept / reject controller
    "ffjord": dict(layers=3, t0=0.0, t1=1.0, stepsize=0.1, solver="dopri5",
                   backprop="adjoint", trace="hutchinson",
                   rtol=1e-4, atol=1e-4),
}
