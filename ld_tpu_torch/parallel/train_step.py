"""The training step; port of `ld_tpu/parallel/train_step.py:26-108`, on one
device or data-parallel over the ranks of a process group.

One step: the detector's `forward_train` (student forward, and for a
distillation detector the frozen teacher's forward and the LD losses), the
sum of the entries whose key contains 'loss' (the reference's
`_parse_losses`; other entries are logged only), backward, the optional
global gradient clip, the optimizer step and the LR step.

Data parallel (R > 1 ranks, each with its own b images): the JAX step is
one objective over the global batch. The heads normalise by global counts
(`parallel.dist.global_sum`), so the ranks' losses are shares that sum to
the global loss. The student runs under `DistributedDataParallel`, whose
gradient is the MEAN over the ranks, so the backward objective is R x the
rank's share: the synced gradient is the gradient of the global sum (the
constant-normalised LD / VLR terms included), the clip sees it, and every
rank steps the same. The logged metrics are the ranks' mean of R x their
shares: the JAX values. The teacher sits outside the student's module
tree, so DDP never sees it. The fsdp / sp / tp and remat parts of the JAX
package are not ported.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch import nn

from .dist import all_reduce_mean, get_dist_info


class _ForwardTrain(nn.Module):
    """`model.forward_train` as a forward, for DistributedDataParallel
    (which syncs only what runs through its own forward)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, **kwargs):
        return self.model.forward_train(batch, **kwargs)


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    grad_clip: Optional[Dict] = None,
                    seed: int = 0
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """The step function: batch -> the detached loss dict plus 'loss', the
    summed objective (over the ranks' global batch, see the module doc).
    Puts `model` in train mode (BNs of norm_eval backbones and a
    distillation teacher stay in eval). Under a process group of R > 1
    ranks the student is wrapped in DistributedDataParallel (BN buffers
    are not broadcast: the trained configs freeze their statistics); its
    parameters are rank 0's from then on.

    grad_clip: mmcv's `optimizer_config.grad_clip`, e.g. dict(max_norm=35,
    norm_type=2), clipping the global norm of the trainable gradients, as
    the reference does (the JAX package's norm also counts the gradients of
    the frozen stages, which it computes and then zeroes).

    seed: a detector whose `forward_train` takes a `generator` (the
    two-stage samplers) gets one on its device, seeded at every step from
    (seed, rank, the scheduler's step), where the JAX package folds the
    step into its key: a resumed run draws what the run it continues
    would have drawn.
    """
    model.train()
    params = [p for g in optimizer.param_groups for p in g['params']]
    rank, world = get_dist_info()
    device = next(model.parameters()).device
    forward = model.forward_train
    kwargs = {}
    if 'generator' in inspect.signature(model.forward_train).parameters:
        kwargs['generator'] = torch.Generator(device=device)
    if world > 1:
        forward = nn.parallel.DistributedDataParallel(
            _ForwardTrain(model),
            device_ids=[device.index] if device.type == 'cuda' else None,
            broadcast_buffers=False)

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if kwargs:
            kwargs['generator'].manual_seed(
                hash((seed, rank, scheduler.last_epoch)) & (2**63 - 1))
        losses = forward(batch, **kwargs)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        optimizer.zero_grad(set_to_none=True)
        (total * world).backward()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(
                params, grad_clip.get('max_norm', 35.0),
                norm_type=grad_clip.get('norm_type', 2))
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() * world for k, v in losses.items()}
        metrics['loss'] = total.detach() * world
        return all_reduce_mean(metrics)

    return train_step
