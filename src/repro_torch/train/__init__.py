from repro_torch.train.step import make_train_step, make_state
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "make_state", "Trainer", "TrainerConfig"]
