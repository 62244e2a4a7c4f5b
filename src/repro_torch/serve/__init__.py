from .config import ServeConfig
from .engine import PagedServeEngine
from .graphs import StepRunner
from .paged_cache import BlockAllocator, OutOfPagesError, PagedKVCache
from .prefix import PrefixIndex
from .sampling import SamplingParams, processed_probs, sample_tokens
from .scheduler import Scheduler, ServeRequest
from .telemetry import Telemetry

__all__ = ["BlockAllocator", "OutOfPagesError", "PagedKVCache",
           "PagedServeEngine", "PrefixIndex", "SamplingParams", "Scheduler",
           "ServeConfig", "ServeRequest", "StepRunner", "Telemetry",
           "processed_probs", "sample_tokens"]
