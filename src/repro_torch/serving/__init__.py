from repro_torch.serving.engine import (HotSwapStream, ServeEngine,
                                        broadcast_params, broadcast_plan,
                                        sample_greedy)
from repro_torch.serving.paged_cache import (PagedKVCache, cache_leaf_paths,
                                             dense_cache_bytes)
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SLOConfig)

__all__ = ["ContinuousBatcher", "HotSwapStream", "PagedKVCache", "Request",
           "SLOConfig", "ServeEngine", "broadcast_params", "broadcast_plan",
           "cache_leaf_paths", "dense_cache_bytes", "sample_greedy"]
