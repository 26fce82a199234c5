from . import math  # noqa: F401
from .bisect import bisect_monotone  # noqa: F401
