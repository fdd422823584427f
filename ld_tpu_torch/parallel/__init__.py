from .dist import (all_gather, all_gather_object, all_reduce_host,
                   all_reduce_mean, barrier, broadcast_object,
                   get_dist_info, global_mean, global_sum, init_dist)
from .optim import build_lr_schedule, build_optimizer
from .train_step import make_train_step

__all__ = ['all_gather', 'all_gather_object', 'all_reduce_host',
           'all_reduce_mean', 'barrier', 'broadcast_object',
           'build_lr_schedule', 'build_optimizer', 'get_dist_info',
           'global_mean', 'global_sum', 'init_dist', 'make_train_step']
