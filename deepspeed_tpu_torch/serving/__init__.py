from .config import ServingConfig  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .request import Request  # noqa: F401
