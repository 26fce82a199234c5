from .bijector import Bijector, Chain, init_children  # noqa: F401
