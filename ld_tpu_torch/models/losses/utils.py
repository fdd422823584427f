"""Weighted-loss contract shared by the port's losses (port of
`ld_tpu/models/losses/utils.py:19-53`).

An element-wise loss is multiplied by an optional per-element weight, then
reduced by `reduction` (none / mean / sum). With `avg_factor`, 'mean' is
`sum / avg_factor`, 'none' returns the weighted loss, and 'sum' raises.
Elements that are absent carry weight 0, so these reductions stand in for a
gather of the positive rows.
"""
from __future__ import annotations

import functools

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'unknown reduction {reduction}')


def weight_reduce_loss(loss: torch.Tensor,
                       weight=None,
                       reduction: str = 'mean',
                       avg_factor=None) -> torch.Tensor:
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / avg_factor
    if reduction == 'none':
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


def weighted_loss(loss_func):
    """Decorator adding (weight, reduction, avg_factor) to an element-wise
    loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', avg_factor=None,
                **kwargs):
        loss = loss_func(pred, target, **kwargs)
        return weight_reduce_loss(loss, weight, reduction, avg_factor)

    return wrapper
