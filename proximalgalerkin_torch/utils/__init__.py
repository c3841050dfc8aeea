from .checkpoint import LVPPCheckpoint
from .profiling import device_trace

__all__ = ["LVPPCheckpoint", "device_trace"]
