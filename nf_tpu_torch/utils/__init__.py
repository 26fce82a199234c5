from .logging import Logging  # noqa: F401
