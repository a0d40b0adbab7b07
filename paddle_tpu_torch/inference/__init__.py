"""paddle.inference counterpart: the engines (``generation.py``, the page
allocator) and the deploy surface (``predictor.py``: ``Config``,
``Predictor``, ``create_predictor``, ``convert_to_mixed_precision``) over
``aot.py``'s ``torch.export`` programs."""
from .generation import (CausalLMEngine, ContinuousBatchingEngine,
                         GenerationConfig, PagedContinuousBatchingEngine,
                         prefill_buckets_for)
from .paged_cache import PageAllocator, write_tokens, write_tokens_q
from .predictor import (Config, PlaceType, PrecisionType, Predictor,
                        convert_to_mixed_precision, create_predictor)

__all__ = ["GenerationConfig", "CausalLMEngine", "ContinuousBatchingEngine",
           "PagedContinuousBatchingEngine", "prefill_buckets_for",
           "PageAllocator", "write_tokens", "write_tokens_q", "Config",
           "Predictor", "create_predictor", "convert_to_mixed_precision",
           "PrecisionType", "PlaceType"]
