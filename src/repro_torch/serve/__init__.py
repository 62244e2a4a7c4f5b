from .config import ServeConfig
from .engine import PagedServeEngine, Request, ServeEngine
from .graphs import StepRunner
from .paged_cache import BlockAllocator, OutOfPagesError, PagedKVCache
from .prefix import PrefixIndex
from .sampling import SamplingParams, processed_probs, sample_tokens
from .scheduler import Scheduler, ServeRequest
from .state import StateArena
from .telemetry import Telemetry

__all__ = ["BlockAllocator", "OutOfPagesError", "PagedKVCache",
           "PagedServeEngine", "PrefixIndex", "Request", "SamplingParams",
           "Scheduler", "ServeEngine",
           "ServeConfig", "ServeRequest", "StateArena", "StepRunner",
           "Telemetry", "processed_probs", "sample_tokens"]
