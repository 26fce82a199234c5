"""Conditioner networks used inside coupling layers (counterpart of
``nf_tpu/nets/conditioners.py``): residual blocks of BN -> ReLU ->
(weight-normed) dense x2 with a bridge projection when widths differ, an
input projection, and a BN -> ReLU -> projection head."""
from __future__ import annotations

from .core import Net, Sequential, relu
from .layers import BatchNormNet, Dense


class ResBlockLinear(Net):
    def __init__(self, in_features: int, out_features: int,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.net = Sequential([
            BatchNormNet(in_features, device=device),
            relu(),
            Dense(in_features, out_features, weight_norm, device),
            BatchNormNet(out_features, device=device),
            relu(),
            Dense(out_features, out_features, weight_norm, device),
        ])
        self.bridge = (Dense(in_features, out_features, weight_norm, device)
                       if in_features != out_features else None)

    def forward(self, x):
        y = self.net(x)
        if self.bridge is not None:
            x = self.bridge(x)
        return x + y


def MLP(in_features: int, out_features: int, base_filters: int = 32,
        n_blocks: int = 2, weight_norm: bool = True, device=None) -> Net:
    """Dense conditioner: in-proj, n residual blocks, BN-ReLU-out-proj."""
    return Sequential(
        [Dense(in_features, base_filters, weight_norm, device)]
        + [ResBlockLinear(base_filters, base_filters, weight_norm, device)
           for _ in range(n_blocks)]
        + [BatchNormNet(base_filters, device=device), relu(),
           Dense(base_filters, out_features, weight_norm, device)]
    )
