"""Core: the paper's contribution — densifying assumed-sparse tensors.

  IndexedSlices           sparse row-slice gradient (tf.IndexedSlices analogue)
  accumulate_gradients    paper Alg. 1 (TF) / Alg. 2 (proposed) accumulation
  ExchangePlan            static collective schedule (bucketing + collectives)
  DistributedOptimizer    Horovod-style wrapper; exchange=ExchangeConfig(...)
"""
from repro_torch.core.indexed_slices import IndexedSlices, concat_slices
from repro_torch.core.accumulation import (accumulate_gradients, densify,
                                           dense_to_slices,
                                           accumulated_nbytes)
from repro_torch.core.exchange import (BucketSchedule, BucketStage,
                                       ExchangeConfig, ExchangePlan,
                                       compile_plan)
from repro_torch.core.dist_opt import DistributedOptimizer
