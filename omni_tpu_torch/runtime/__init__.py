from .context import BUCKETS, Batch, Context, KVCacheFull
from .kv_cache import MAX_SEQS, KVCache
from .sampler import SamplerParams

__all__ = ["BUCKETS", "Batch", "Context", "KVCache", "KVCacheFull",
           "MAX_SEQS", "SamplerParams"]
