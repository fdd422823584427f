"""The training step on one device; port of the single-device part of
`ld_tpu/parallel/train_step.py:26-108`.

One step: the detector's `forward_train` (student forward, and for a
distillation detector the frozen teacher's forward and the LD losses), the
sum of the entries whose key contains 'loss' (the reference's
`_parse_losses`; other entries are logged only), backward, the optional
global gradient clip, the optimizer step and the LR step. The mesh, pjit,
fsdp / sp / tp and remat parts of the JAX package are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    grad_clip: Optional[Dict] = None
                    ) -> Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """The step function: batch -> the detached loss dict plus 'loss', the
    summed objective. Puts `model` in train mode (BNs of norm_eval
    backbones and a distillation teacher stay in eval).

    grad_clip: mmcv's `optimizer_config.grad_clip`, e.g. dict(max_norm=35,
    norm_type=2), clipping the global norm of the trainable gradients, as
    the reference does (the JAX package's norm also counts the gradients of
    the frozen stages, which it computes and then zeroes).
    """
    model.train()
    params = [p for g in optimizer.param_groups for p in g['params']]

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        losses = model.forward_train(batch)
        total = sum(v for k, v in losses.items() if 'loss' in k)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(
                params, grad_clip.get('max_norm', 35.0),
                norm_type=grad_clip.get('norm_type', 2))
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics['loss'] = total.detach()
        return metrics

    return train_step
