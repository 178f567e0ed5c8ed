"""Serving substrate: chunked prefill + paged KV cache + continuous
batching, with an async submit/poll queue and admission control."""
from .engine import ServeConfig, ServingEngine, reference_generate
from .paged_cache import BlockManager
from .queue import (DECODE, DONE, PREFILL, QUEUED, REJECT_CODES,
                    REJECT_DEADLINE_EXPIRED, REJECT_PROMPT_OVER_BUDGET,
                    REJECT_QUEUE_FULL, REJECT_RESERVATION_OVER_POOL,
                    REJECT_RETRY_EXHAUSTED, REJECT_WATCHDOG_ABORT,
                    REJECTED, TERMINAL, Request, RequestQueue)

__all__ = ["ServeConfig", "ServingEngine", "reference_generate",
           "BlockManager", "Request", "RequestQueue", "QUEUED", "PREFILL",
           "DECODE", "DONE", "REJECTED", "TERMINAL", "REJECT_CODES",
           "REJECT_QUEUE_FULL", "REJECT_PROMPT_OVER_BUDGET",
           "REJECT_RESERVATION_OVER_POOL", "REJECT_DEADLINE_EXPIRED",
           "REJECT_RETRY_EXHAUSTED", "REJECT_WATCHDOG_ABORT"]
