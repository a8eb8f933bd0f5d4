from .engine import Request, Result, ServeEngine, dequantize_packed_params  # noqa: F401
from .scheduler import ContinuousScheduler, SchedulerPolicy  # noqa: F401
from .slots import BlockAllocator, SlotPool  # noqa: F401
