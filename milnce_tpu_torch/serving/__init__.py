"""Online text->video retrieval serving (port of ``milnce_tpu/serving/``).

Ported so far: the params-only export that feeds serving (``export``),
a bucketed embedding engine warmed at start-up (``engine``), a dynamic
micro-batcher with per-request deadlines (``batcher``), an LRU
text-embedding cache (``cache``) and an exact top-k index whose corpus
lives on the card (``index``).  The live index, the replica pool and
the HTTP service are not ported yet.

Import discipline: ``batcher`` and ``cache`` are numpy-only host code;
``engine``/``index`` own every device interaction, each through one
explicit copy each way under the process's dispatch lock.
"""

from milnce_tpu_torch.serving.batcher import DeadlineExpired, DynamicBatcher
from milnce_tpu_torch.serving.cache import EmbeddingLRUCache

__all__ = [
    "DeadlineExpired",
    "DynamicBatcher",
    "EmbeddingLRUCache",
]
