from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.adamw import (AdamState, MomentumState, adamw,
                                     sgd_momentum)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        noam_schedule)
from repro_torch.optim.zero1 import Zero1State
