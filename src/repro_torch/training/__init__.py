from repro_torch.training.gradients import grad_contributions
from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig
