"""The compile layer — port of ``spark_rapids_tpu/compile``: the
capacity ladder and its tiers (:mod:`.ladder`) and fused programs as
CUDA graphs (:mod:`.executables`). The reference's capture-cost budget,
persistent manifest and warm-up (``budget.py``, ``persist.py``,
``warmup.py``) are not ported: a capture takes milliseconds, and a CUDA
graph cannot be written to disk.
"""

from __future__ import annotations

from .ladder import BucketLadder, bucket_capacity, get_ladder, set_ladder

__all__ = ["BucketLadder", "bucket_capacity", "get_ladder", "set_ladder",
           "configure"]


def configure(conf) -> dict:
    """Configure the compile layer's globals from a session's conf (the
    reference's ``compile/__init__.py:45-92``, without the budget,
    persistence and warm-up): the upload cache's byte budget. Called by
    ``TorchSession``; idempotent. Returns ``{"ladder": ladder}``."""
    from ..config import UPLOAD_CACHE_BYTES
    from ..data import upload_cache
    upload_cache.set_budget(int(conf.get(UPLOAD_CACHE_BYTES)))
    return {"ladder": get_ladder()}
