from .coupling import AffineCoupling, merge1d, split1d  # noqa: F401
from .norm import BatchNorm  # noqa: F401
