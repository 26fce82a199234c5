"""Configuration fields the ported model builders read.

Counterpart of ``nf_tpu/config.py``: the port keeps its own copy of the
``NetworkConfig`` fields that its builders use, with the same names and
defaults, and ``NETWORK_DEFAULTS`` for the ported networks.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NetworkConfig:
    name: str = "realnvp"
    layers: int = 32
    # flow++ mixture components (configs/network/flow++.yaml)
    mixtures: int = 8
    # resflow (configs/network/resflow.yaml)
    logdet: str = "unbias"
    spnorm_coeff: float = 0.9
    # conditioner width (reference MLP/ConvNet base_filters=32)
    base_filters: int = 32


# per-network defaults mirroring configs/network/*.yaml
NETWORK_DEFAULTS = {
    "realnvp": dict(layers=32),
    "glow": dict(layers=32),
    "flow++": dict(layers=32, mixtures=8),
    "resflow": dict(layers=32, logdet="unbias", spnorm_coeff=0.9),
}
