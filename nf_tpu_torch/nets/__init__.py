from .conditioners import MLP, ResBlockLinear  # noqa: F401
from .core import Activation, Net, Sequential, relu  # noqa: F401
from .gated import GatedAttn, GatedLinear, LayerNormNet  # noqa: F401
from .layers import BatchNormNet, Dense  # noqa: F401
