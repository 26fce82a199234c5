from .conditioners import MLP, ConvNet, ResBlock2d, ResBlockLinear  # noqa: F401
from .core import Activation, Net, Sequential, relu  # noqa: F401
from .gated import GatedAttn, GatedLinear, LayerNormNet  # noqa: F401
from .layers import BatchNormNet, Conv2d, Dense  # noqa: F401
