"""Core: the paper's contribution — densifying assumed-sparse tensors.

  IndexedSlices           sparse row-slice gradient (tf.IndexedSlices analogue)
  accumulate_gradients    paper Alg. 1 (TF) / Alg. 2 (proposed) accumulation
  ExchangePlan            static collective schedule (bucketing + collectives)
  DistributedOptimizer    Horovod-style wrapper; exchange=ExchangeConfig(...)
  get_codec / ExchangeState  wire codecs and their per-bucket state
  get_backend             collective backends (flat, hierarchical, ringsim)
"""
from repro_torch.core.indexed_slices import IndexedSlices, concat_slices
from repro_torch.core.accumulation import (accumulate_gradients, densify,
                                           dense_to_slices,
                                           accumulated_nbytes)
from repro_torch.core.backend import (CollectiveBackend,
                                      available_backends, get_backend,
                                      register_backend)
from repro_torch.core.codecs import (ExchangeState, WireCodec,
                                     available_codecs, get_codec,
                                     register_codec)
from repro_torch.core.exchange import (BucketSchedule, BucketStage,
                                       ExchangeConfig, ExchangePlan,
                                       compile_plan)
from repro_torch.core.dist_opt import DistributedOptimizer, ExchangeStats
