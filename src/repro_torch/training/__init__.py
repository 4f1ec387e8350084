from repro_torch.training.gradients import (abstract_grad_contributions,
                                            grad_contributions,
                                            wait_free_grad_exchange)
from repro_torch.training.microbatch import (LossScaler, ScalerState,
                                             accumulate_microbatches,
                                             make_scaled_train_step,
                                             split_microbatches)
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig
