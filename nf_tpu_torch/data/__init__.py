"""Data tier (counterpart of ``nf_tpu/data``): toy samplers (numpy and the
native library), image readers, and the sharded ``FlowDataLoader``."""
from . import native  # noqa: F401
from .images import IMAGE_DATASETS, load_images, synthetic_images  # noqa: F401
from .loader import POOL_SIZE, FlowDataLoader  # noqa: F401
from .toy import TOY_SAMPLERS  # noqa: F401
