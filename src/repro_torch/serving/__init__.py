"""Batched, shape-bucketed serving layer for the PS³ picker.

`engine.BatchPicker` is the batched execution core (one vectorized
feature pass, bounded compiles, answer LRU); `frontdoor.FrontDoor` is
the concurrency layer above it — admission control, backpressure, and
graceful degradation under overload.
"""
from repro_torch.serving.engine import BatchPicker, ServingStats
from repro_torch.serving.frontdoor import (
    CircuitBreaker,
    FrontDoor,
    FrontDoorConfig,
    Ticket,
    TokenBucket,
)

__all__ = [
    "BatchPicker",
    "CircuitBreaker",
    "FrontDoor",
    "FrontDoorConfig",
    "ServingStats",
    "Ticket",
    "TokenBucket",
]
