from .bijector import (Bijector, Chain, Inverted, ScannedChain, call_forward,  # noqa: F401
                       init_children, replaying, scan_repeated)
