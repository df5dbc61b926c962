"""Online text->video retrieval serving (port of ``milnce_tpu/serving/``).

The params-only export that feeds serving (``export``), a bucketed
embedding engine warmed at start-up (``engine``; it serves the f32 and
the int8 v2 artifacts), a dynamic micro-batcher with per-request
deadlines (``batcher``), an LRU text-embedding cache (``cache``), an
exact top-k index whose corpus lives on the card (``index``) and its
live, generation-swapped twin (``live_index``), the replica pool with
health-gated routing, requeue, hedging and replica classes (``pool``),
and the HTTP service with admission control and SLO tiers (``service``,
console script ``milnce-serve-torch``).

Import discipline: ``batcher``, ``cache`` and ``pool`` are host code;
``engine`` and the indexes own every device interaction, each through
one explicit copy each way under a dispatch lock.
"""

from milnce_tpu_torch.serving.batcher import DeadlineExpired, DynamicBatcher
from milnce_tpu_torch.serving.cache import EmbeddingLRUCache

__all__ = [
    "DeadlineExpired",
    "DynamicBatcher",
    "EmbeddingLRUCache",
]
