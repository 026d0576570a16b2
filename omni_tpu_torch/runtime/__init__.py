from .context import BUCKETS, Batch, Context, KVCacheFull
from .kv_cache import KVCache
from .sampler import SamplerParams

__all__ = ["BUCKETS", "Batch", "Context", "KVCache", "KVCacheFull",
           "SamplerParams"]
