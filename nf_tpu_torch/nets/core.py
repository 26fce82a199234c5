"""Minimal module protocol for (non-bijective) conditioner networks
(counterpart of ``nf_tpu/nets/core.py``)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.bijector import init_children


class Net(nn.Module):
    """Base class: ``forward(x) -> y``; ``init(generator)`` re-draws the
    parameters in place."""

    def init(self, generator: torch.Generator) -> None:
        init_children(self, generator)


class Sequential(Net):
    def __init__(self, layers: Sequence[Net]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Activation(Net):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def relu():
    return Activation(torch.relu)


def elu():
    return Activation(torch.nn.functional.elu)


def softplus():
    return Activation(torch.nn.functional.softplus)
