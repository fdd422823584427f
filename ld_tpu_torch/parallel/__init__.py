from .optim import build_lr_schedule, build_optimizer
from .train_step import make_train_step

__all__ = ['build_lr_schedule', 'build_optimizer', 'make_train_step']
