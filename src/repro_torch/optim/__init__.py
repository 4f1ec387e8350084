from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.adamw import AdamState, adamw
from repro_torch.optim.schedule import noam_schedule
