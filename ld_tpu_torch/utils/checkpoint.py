"""Weights in and out of the port.

  * `load_checkpoint`: a published mmdet `.pth` (or a bare state dict) loads
    straight into the port's modules with `load_state_dict(strict=True)`,
    because the port uses mmdet's module names.
  * `state_dict_from_jax`: the exact inverse of
    `ld_tpu.utils.checkpoint.convert_torch_state_dict` for the ResNet / FPN /
    GFL-head families (the LD head has the GFL head's parameters). It takes
    the JAX package's {'params', 'batch_stats'} tree as nested dicts of
    numpy arrays and returns the port's mmdet-named state dict, so both
    packages can run on the same weights.
  * `load_from_jax`: loads such trees strictly into a model and, for a
    distillation detector, the JAX package's separate teacher tree into
    `model.teacher`.
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an mmdet checkpoint ({'state_dict': ...}) or a bare state dict
    into `model`, strictly: every key must match."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    model.load_state_dict(sd, strict=True)
    return model


def _leaves(tree: Dict, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key, ))
        else:
            yield prefix + (key, ), np.asarray(value)


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.transpose(kernel, (3, 2, 0, 1))


_BN_LEAVES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
              'var': 'running_var'}


def _backbone_key(path: tuple) -> str:
    """('conv1', 'kernel') / ('layer1_0', 'norm2', 'bn', 'scale') / ... ->
    the mmdet ResNet name after 'backbone.'."""
    *mods, leaf = path
    if mods[-1] == 'bn':          # BatchNorm: .../normX/bn/<leaf>
        norm = mods[-2]
        owner = mods[:-2]
        name = {'norm1': 'bn1', 'norm2': 'bn2', 'norm3': 'bn3',
                'downsample_norm': 'downsample.1'}[norm]
        return '.'.join(_block_prefix(owner) + [name, _BN_LEAVES[leaf]])
    if leaf != 'kernel':
        raise KeyError(path)
    conv = mods[-1]
    name = 'downsample.0' if conv == 'downsample_conv' else conv
    return '.'.join(_block_prefix(mods[:-1]) + [name, 'weight'])


def _block_prefix(owner) -> list:
    if not owner:
        return []
    m = re.fullmatch(r'layer(\d)_(\d+)', owner[0])
    if m is None or len(owner) != 1:
        raise KeyError(owner)
    return [f'layer{m.group(1)}', m.group(2)]


def _neck_key(path: tuple, num_laterals: int) -> str:
    mod, leaf = path
    name = 'weight' if leaf == 'kernel' else 'bias'
    m = re.fullmatch(r'(lateral|fpn_conv|fpn_extra)_(\d+)', mod)
    if m is None:
        raise KeyError(path)
    kind, i = m.group(1), int(m.group(2))
    if kind == 'lateral':
        return f'lateral_convs.{i}.conv.{name}'
    if kind == 'fpn_extra':
        i += num_laterals
    return f'fpn_convs.{i}.conv.{name}'


def _head_key(path: tuple) -> str:
    m = re.fullmatch(r'(cls|reg)_conv(\d+)', path[0])
    if m is not None:
        kind, i = m.groups()
        sub, leaf = path[1:]
        if sub == 'Conv_0' and leaf == 'kernel':
            return f'{kind}_convs.{i}.conv.weight'
        if sub == 'GroupNorm_0':
            return f'{kind}_convs.{i}.gn.' + {'scale': 'weight',
                                              'bias': 'bias'}[leaf]
        raise KeyError(path)
    if path[0] in ('gfl_cls', 'gfl_reg') and len(path) == 2:
        return f'{path[0]}.' + {'kernel': 'weight', 'bias': 'bias'}[path[1]]
    raise KeyError(path)


def state_dict_from_jax(variables: Dict) -> 'OrderedDict[str, torch.Tensor]':
    """JAX {'params', 'batch_stats'} tree (numpy leaves) -> the port's
    mmdet-named state dict, including each BatchNorm's
    `num_batches_tracked` (0), so `load_state_dict(strict=True)` accepts it.

    Raises KeyError on a leaf outside the ResNet / FPN / GFL-head families.
    """
    sd: Dict[str, np.ndarray] = {}
    params = variables['params']
    num_laterals = sum(1 for k in params.get('neck', {})
                       if k.startswith('lateral_'))
    for coll in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(coll, {})):
            scope, rest = path[0], path[1:]
            if scope == 'backbone':
                key = 'backbone.' + _backbone_key(rest)
                if rest[-2:] == ('bn', 'scale'):
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'neck':
                key = 'neck.' + _neck_key(rest, num_laterals)
            elif scope == 'head_net' and rest == ('scales', ):
                for lvl, s in enumerate(value):
                    sd[f'bbox_head.scales.{lvl}.scale'] = np.float32(s)
                continue
            elif scope == 'head_net':
                key = 'bbox_head.' + _head_key(rest)
            else:
                raise KeyError(path)
            if key.endswith('.weight') and value.ndim == 4:
                value = _conv_weight(value)
            sd[key] = value
    return OrderedDict((k, torch.from_numpy(np.array(v)))
                       for k, v in sorted(sd.items()))


def load_from_jax(model: torch.nn.Module, variables: Dict,
                  teacher_variables: Dict = None) -> torch.nn.Module:
    """Load the JAX package's variables into `model`, and its
    `teacher_variables` (a pytree of their own there) into `model.teacher`;
    every key must match on both."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    if teacher_variables is not None:
        model.teacher.load_state_dict(state_dict_from_jax(teacher_variables),
                                      strict=True)
    return model
