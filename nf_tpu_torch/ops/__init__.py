from . import math  # noqa: F401
