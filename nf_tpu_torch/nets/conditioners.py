"""Conditioner networks used inside coupling layers (counterpart of
``nf_tpu/nets/conditioners.py``): residual blocks of BN -> ReLU ->
(weight-normed) dense or 3x3 conv, twice, with a bridge projection when
widths differ, an input projection, and a BN -> ReLU -> projection head.
``compute_dtype`` goes to every dense layer and conv (``nets/layers.py``):
with ``"bfloat16"`` the net computes in bf16 and returns bf16."""
from __future__ import annotations

from .core import Net, Sequential, relu
from .layers import BatchNormNet, Conv2d, Dense


class ResBlockLinear(Net):
    def __init__(self, in_features: int, out_features: int,
                 weight_norm: bool = True, device=None, compute_dtype=None):
        super().__init__()
        proj = self._projection
        self.net = Sequential([
            BatchNormNet(in_features, device=device),
            relu(),
            proj(in_features, out_features, weight_norm, device, compute_dtype),
            BatchNormNet(out_features, device=device),
            relu(),
            proj(out_features, out_features, weight_norm, device, compute_dtype),
        ])
        self.bridge = (proj(in_features, out_features, weight_norm, device, compute_dtype)
                       if in_features != out_features else None)

    @staticmethod
    def _projection(in_features, out_features, weight_norm, device, compute_dtype) -> Net:
        return Dense(in_features, out_features, weight_norm, device, compute_dtype)

    def forward(self, x):
        y = self.net(x)
        if self.bridge is not None:
            x = self.bridge(x)
        return x + y


class ResBlock2d(ResBlockLinear):
    """The same block over NHWC maps, with 3x3 convs."""

    @staticmethod
    def _projection(in_channels, out_channels, weight_norm, device, compute_dtype) -> Net:
        return Conv2d(in_channels, out_channels, 3, weight_norm, device, compute_dtype)


def MLP(in_features: int, out_features: int, base_filters: int = 32,
        n_blocks: int = 2, weight_norm: bool = True, device=None,
        compute_dtype=None) -> Net:
    """Dense conditioner: in-proj, n residual blocks, BN-ReLU-out-proj."""
    cd = compute_dtype
    return Sequential(
        [Dense(in_features, base_filters, weight_norm, device, cd)]
        + [ResBlockLinear(base_filters, base_filters, weight_norm, device, cd)
           for _ in range(n_blocks)]
        + [BatchNormNet(base_filters, device=device), relu(),
           Dense(base_filters, out_features, weight_norm, device, cd)]
    )


def ConvNet(in_channels: int, out_channels: int, base_filters: int = 32,
            n_blocks: int = 2, weight_norm: bool = True, device=None,
            compute_dtype=None) -> Net:
    """Conv conditioner: 3x3 in-proj, n residual blocks, BN-ReLU-1x1 head."""
    cd = compute_dtype
    return Sequential(
        [Conv2d(in_channels, base_filters, 3, weight_norm, device, cd)]
        + [ResBlock2d(base_filters, base_filters, weight_norm, device, cd)
           for _ in range(n_blocks)]
        + [BatchNormNet(base_filters, device=device), relu(),
           Conv2d(base_filters, out_channels, 1, weight_norm, device, cd)]
    )
