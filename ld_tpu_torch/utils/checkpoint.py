"""Weights in and out of the port.

  * `load_checkpoint`: a published mmdet `.pth` (or a bare state dict, or a
    JAX `.npz`) loads straight into the port's modules with
    `load_state_dict(strict=True)`, because the port uses mmdet's module
    names.
  * `state_dict_from_jax`: the exact inverse of
    `ld_tpu.utils.checkpoint.convert_torch_state_dict` for the ResNet / FPN /
    GFL-head families (the LD head has the GFL head's parameters). It takes
    the JAX package's {'params', 'batch_stats'} tree as nested dicts of
    numpy arrays and returns the port's mmdet-named state dict, so both
    packages can run on the same weights.
  * `load_from_jax`: loads such trees strictly into a model and, for a
    distillation detector, the JAX package's separate teacher tree into
    `model.teacher`.
  * The train state (in place of the JAX package's orbax checkpoints,
    `ld_tpu/utils/checkpoint.py:29-51`): `save_checkpoint` writes the
    model's state dict, the optimizer's and LR scheduler's states and the
    step to `work_dir/checkpoints/<step>.pth`, keeping the newest
    `max_keep_ckpts`; `load_train_state` restores the latest (or a named
    file) into a model, optimizer and scheduler.
  * `merge_state_dict`: the lenient, shape-checked load of `load_from`,
    reporting what loaded and what was skipped.
  * `read_state_dict`: the state dict of a `.pth`, or of the JAX package's
    `save_variables` `.npz` through `state_dict_from_jax`, so that
    `load_checkpoint(model.teacher, path)` loads a teacher trained by
    either package, strictly.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an mmdet checkpoint ({'state_dict': ...}), a bare state dict or
    a JAX `.npz` (see `read_state_dict`) into `model`, strictly: every key
    must match."""
    model.load_state_dict(read_state_dict(path), strict=True)
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


# --------------------------------------------------------------------------
# train state: save / resume
# --------------------------------------------------------------------------

def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(work_dir, 'checkpoints')


def _saved_steps(work_dir: str) -> List[int]:
    path = _ckpt_dir(work_dir)
    if not os.path.isdir(path):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(path)
                  if f.endswith('.pth') and f[:-4].isdigit())


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest `checkpoints/<step>.pth` of `work_dir`, or None."""
    steps = _saved_steps(work_dir)
    return os.path.join(_ckpt_dir(work_dir), f'{steps[-1]}.pth') \
        if steps else None


def save_checkpoint(work_dir: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    step: int, keep: int = 3) -> str:
    """Write the train state at `step` to `work_dir/checkpoints/<step>.pth`
    (atomically: a crash leaves the previous checkpoint the latest), then
    delete all but the newest `keep`; returns the file's path."""
    path = _ckpt_dir(work_dir)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f'{step}.pth')
    tmp = f'{out}.{os.getpid()}.tmp'
    torch.save(dict(state_dict=model.state_dict(),
                    optimizer=optimizer.state_dict(),
                    scheduler=scheduler.state_dict(), step=int(step)), tmp)
    os.replace(tmp, out)
    if keep:
        for old in _saved_steps(work_dir)[:-keep]:
            os.remove(os.path.join(path, f'{old}.pth'))
    return out


def load_train_state(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     scheduler: torch.optim.lr_scheduler.LRScheduler
                     ) -> int:
    """Restore a train state saved by `save_checkpoint` (the latest of a
    work dir, or the file named) strictly into `model`, `optimizer` and
    `scheduler`; returns its step."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f'no checkpoint under {path}')
        path = found
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    optimizer.load_state_dict(ckpt['optimizer'])
    scheduler.load_state_dict(ckpt['scheduler'])
    return int(ckpt['step'])


# --------------------------------------------------------------------------
# load_from and teachers
# --------------------------------------------------------------------------

def load_variables(path: str) -> Dict:
    """A JAX `save_variables` `.npz` (flat 'a/b/c' keys) as nested dicts of
    numpy arrays."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split('/')
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a `.pth` (an mmdet checkpoint, a train state of
    `save_checkpoint`, or a bare state dict) or in a JAX `.npz`."""
    if path.endswith('.npz'):
        return state_dict_from_jax(load_variables(path))
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    return ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt


def merge_state_dict(model: torch.nn.Module,
                     state_dict: Dict[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Copy every entry of `state_dict` whose name and shape match one of
    `model`'s; the rest of the model keeps its values (mmcv's
    `load_checkpoint(strict=False)`, for fine-tuning). Returns (loaded,
    skipped) names."""
    own = model.state_dict()
    loaded, skipped = [], []
    for name, value in state_dict.items():
        if name in own and tuple(own[name].shape) == tuple(value.shape):
            loaded.append(name)
        else:
            skipped.append(name)
    model.load_state_dict({n: state_dict[n] for n in loaded}, strict=False)
    return loaded, skipped
