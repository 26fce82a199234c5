from .bijector import Bijector, Chain, Inverted, call_forward, init_children  # noqa: F401
