from .checkpoint import LVPPCheckpoint
from .profiling import annotate, device_trace

__all__ = ["LVPPCheckpoint", "annotate", "device_trace"]
