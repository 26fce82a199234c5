from .cnf import CNF, ODENet  # noqa: F401
from .conv1x1 import InvertibleConv1x1  # noqa: F401
from .coupling import AdditiveCoupling, AffineCoupling, merge1d, split1d  # noqa: F401
from .elementwise import Arctanh, Identity, Logit, Sigmoid, Tanh  # noqa: F401
from .flowpp_coupling import MixLogAttnCoupling  # noqa: F401
from .made import MADE, AutoregressiveTransform  # noqa: F401
from .norm import ActNorm, BatchNorm  # noqa: F401
from .planar import PlanarTransform  # noqa: F401
from .squeeze import (Flatten, Squeeze1d, Squeeze2d,  # noqa: F401
                      Unsqueeze1d, Unsqueeze2d)
from .vardequant import VariationalDequant  # noqa: F401
