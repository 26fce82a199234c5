"""Configuration: nested dataclasses and dotted ``key=value`` overrides
(counterpart of ``nf_tpu/config.py``).

The port keeps its own copy of nf_tpu's tree with the same field names,
defaults and errors: ``NetworkConfig`` (with ``NETWORK_DEFAULTS`` per
network), ``TrainConfig``, ``OptimizerConfig``, ``RunConfig`` and
``Config``.  ``parse_cli`` reads ``network=<name>`` first, so that
network's defaults apply before the overrides, then every ``a.b=value``
token, its value coerced by ``_coerce`` (bool, None, int, float, then
str).  ``run.platform`` names the device: None or "cuda" the card, "cpu"
the CPU (``platform_device``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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


@dataclass
class TrainConfig:
    steps: int = 100000
    samples: int = 1024  # the batch size (per rank under data parallelism)
    # optimizer steps taken per loop iteration (``Trainer.train_steps``);
    # the log, metric and checkpoint cadences coarsen to it
    chunk: int = 1


@dataclass
class RunConfig:
    debug: bool = False
    distrib: str = "circles"
    ckpt_path: Optional[str] = None
    output: str = "outputs"
    display: int = 1
    seed: int = 42
    data_root: str = "data"
    save_all_reports: bool = False
    # uniform dequantization of 8-bit image data: y = (255 x + u) / 256
    dequantize: bool = False
    # the device: None or "cuda" the card, "cpu" the CPU
    platform: Optional[str] = None
    # "auto" resumes from the newest logs/<network>_<distrib>_*/latest.npz
    # and continues in that run directory; a run directory resumes that
    # run; None starts afresh (``ckpt_path`` loads one file and wins)
    resume: Optional[str] = None


@dataclass
class Config:
    network: NetworkConfig = field(default_factory=NetworkConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    run: RunConfig = field(default_factory=RunConfig)


def _coerce(current, value: str):
    if isinstance(current, bool) or value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("null", "none"):
        return None
    for typ in (int, float):
        try:
            return typ(value)
        except ValueError:
            continue
    return value


def parse_cli(argv) -> Config:
    """Parse ``key=value`` overrides (e.g. network=glow run.distrib=moons)."""
    cfg = Config()
    # first pass: the network group, so its defaults apply before overrides
    for tok in argv:
        if tok.startswith("network="):
            name = tok.split("=", 1)[1]
            if name not in NETWORK_DEFAULTS:
                raise ValueError(f"unknown network {name!r}; "
                                 f"choose from {sorted(NETWORK_DEFAULTS)}")
            cfg.network = NetworkConfig(name=name, **NETWORK_DEFAULTS[name])
    for tok in argv:
        if "=" not in tok:
            raise ValueError(f"override must be key=value, got {tok!r}")
        path, value = tok.split("=", 1)
        if path == "network":
            continue
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise ValueError(f"unknown config key {path!r}")
        setattr(obj, leaf, _coerce(getattr(obj, leaf), value))
    return cfg


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


PLATFORMS = (None, "cuda", "cpu")


def platform_device(platform: Optional[str]) -> Optional[str]:
    """``run.platform`` as a device for ``build_model``: None (the card,
    which raises there without one) for None or "cuda", "cpu" for the
    CPU; anything else raises ``ValueError``."""
    if platform not in PLATFORMS:
        raise ValueError(f"run.platform must be one of {PLATFORMS}, got {platform!r}")
    return "cpu" if platform == "cpu" else None
