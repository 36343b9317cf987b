from .config import ServingConfig, SpeculationConfig  # noqa: F401
from .engine import ServingEngine  # noqa: F401
from .paging.config import PagingConfig  # noqa: F401
from .qos import QosClass, QosConfig, QosController  # noqa: F401
from .request import Request  # noqa: F401
