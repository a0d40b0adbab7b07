from .generation import (CausalLMEngine, ContinuousBatchingEngine,
                         GenerationConfig, PagedContinuousBatchingEngine,
                         prefill_buckets_for)
from .paged_cache import PageAllocator, write_tokens, write_tokens_q

__all__ = ["GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "prefill_buckets_for",
           "PageAllocator", "write_tokens", "write_tokens_q"]
