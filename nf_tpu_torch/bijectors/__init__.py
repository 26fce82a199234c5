from .conv1x1 import InvertibleConv1x1  # noqa: F401
from .coupling import AffineCoupling, merge1d, split1d  # noqa: F401
from .flowpp_coupling import MixLogAttnCoupling  # noqa: F401
from .norm import ActNorm, BatchNorm  # noqa: F401
