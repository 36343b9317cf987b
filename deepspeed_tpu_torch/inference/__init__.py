from .engine import InferenceEngine  # noqa: F401
from .generation import generate  # noqa: F401
