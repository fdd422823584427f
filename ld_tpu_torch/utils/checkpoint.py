"""Weights in and out of the port.

  * `load_checkpoint`: a published mmdet `.pth` (or a bare state dict, or a
    JAX `.npz`) loads straight into the port's modules with
    `load_state_dict(strict=True)`, because the port uses mmdet's module
    names.
  * `state_dict_from_jax`: the exact inverse of
    `ld_tpu.utils.checkpoint.convert_torch_state_dict` for the ResNet /
    ResNeXt (with DCN stages) / FPN
    and the GFL, GFocalV2, ATSS-GFL and Retina-GFL heads (an LD head has its
    base head's parameters; the JAX FCOS-GFL head is left out, its final
    convs carry the ATSS head's names). It takes
    the JAX package's {'params', 'batch_stats'} tree as nested dicts of
    numpy arrays and returns the port's mmdet-named state dict, so both
    packages can run on the same weights. It also maps the deep stem, the
    avg-down shortcut and Res2Net (DCN splits too), which that converter
    leaves unmapped or mis-maps (ROADMAP.md Queue C, caveat 16): for those
    it is the only way weights cross between the packages.
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
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an mmdet checkpoint ({'state_dict': ...}), a bare state dict or
    a JAX `.npz` (see `read_state_dict`) into `model`, strictly: every key
    must match."""
    model.load_state_dict(read_state_dict(path, model.state_dict().keys()),
                          strict=True)
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


def _module_name(name: str, avg_down: bool) -> str:
    """A JAX backbone module's name -> mmdet's: `normX` -> `bnX`, the deep
    stem's `stem_convI` / `stem_normI` -> `stem.{3(I-1)}` / `stem.{3I-2}`,
    Res2Net's `convsI` / `bnsI` -> `convs.I` / `bns.I`, and the shortcut's
    `downsample_conv` / `downsample_norm` -> `downsample.{0,1}`, or, behind
    an avg-down pool, `downsample.{1,2}`."""
    m = re.fullmatch(r'stem_(conv|norm)(\d)', name)
    if m is not None:
        return f'stem.{3 * (int(m.group(2)) - 1) + (m.group(1) == "norm")}'
    m = re.fullmatch(r'(convs|bns)(\d+)', name)
    if m is not None:
        return f'{m.group(1)}.{m.group(2)}'
    shortcut = {'downsample_conv': 0, 'downsample_norm': 1}.get(name)
    if shortcut is not None:
        return f'downsample.{shortcut + avg_down}'
    if re.fullmatch(r'conv\d', name):
        return name
    return {'norm1': 'bn1', 'norm2': 'bn2', 'norm3': 'bn3'}[name]


def _backbone_key(path: tuple, avg_down: bool = False) -> str:
    """('conv1', 'kernel') / ('layer1_0', 'norm2', 'bn', 'scale') /
    ('layer3_0', 'conv2', 'conv_offset', 'bias') / ... -> the mmdet
    ResNet / Res2Net name after 'backbone.' (`_module_name`)."""
    *mods, leaf = path
    if mods[-1] == 'bn':          # BatchNorm: .../normX/bn/<leaf>
        return '.'.join(_block_prefix(mods[:-2]) + [
            _module_name(mods[-2], avg_down), _BN_LEAVES[leaf]])
    if mods[-1] == 'conv_offset':  # a DCN conv's offset / mask conv
        return '.'.join(_block_prefix(mods[:-2]) + [
            _module_name(mods[-2], avg_down), 'conv_offset',
            {'kernel': 'weight', 'bias': 'bias'}[leaf]])
    if leaf != 'kernel':
        raise KeyError(path)
    return '.'.join(_block_prefix(mods[:-1]) + [
        _module_name(mods[-1], avg_down), 'weight'])


def _block_prefix(owner) -> list:
    if not owner:
        return []
    m = re.fullmatch(r'layer(\d)_(\d+)', owner[0])
    if m is None or len(owner) != 1:
        raise KeyError(owner)
    return [f'layer{m.group(1)}', m.group(2)]


def _dcn_offset_perm(out_ch: int, k: int) -> np.ndarray:
    """The JAX converter's `conv_offset` channel permutation (a copy of
    `ld_tpu/utils/checkpoint.py:92-111`): perm[jax channel] = mmcv channel.
    mmcv's channels are (o1, o2, mask) thirds, the offsets read per deform
    group as interleaved (dy, dx) pairs a tap; the JAX layer's are
    component-major (all dy, all dx, all mask) blocks per deform group."""
    g = out_ch // (3 * k * k)
    if g * 3 * k * k != out_ch:
        raise ValueError(f'{out_ch} conv_offset channels for k={k}')
    kk = k * k
    perm = np.empty(out_ch, np.int64)
    for gi in range(g):
        for t in range(kk):
            perm[gi * 3 * kk + t] = gi * 2 * kk + 2 * t
            perm[gi * 3 * kk + kk + t] = gi * 2 * kk + 2 * t + 1
            perm[gi * 3 * kk + 2 * kk + t] = 2 * g * kk + gi * kk + t
    return perm


def _dcn_value(params: Dict, rest: tuple, value: np.ndarray):
    """A DCN conv leaf (a ResNet conv2, a Res2Net split conv) of the JAX backbone as the port's tensor, or None
    for any other leaf. k and the input channels per conv group come from
    the layer's own `conv_offset` kernel (k, k, C, 3*g*k*k):
      * the main kernel (k*k*C/groups, O), grouped-HWIO rows, -> OIHW;
      * `conv_offset`'s kernel and bias, the inverse of `_dcn_offset_perm`
        on their output channels."""
    if 'conv_offset' in rest:
        owner = rest[:rest.index('conv_offset') + 1]
    elif rest[-1] == 'kernel' and value.ndim == 2:
        owner = rest[:-1] + ('conv_offset', )
    else:
        return None
    node = params
    for p in owner:
        node = node[p]
    k = np.shape(node['kernel'])[0]
    if 'conv_offset' not in rest:
        return _conv_weight(value.reshape(k, k, -1, value.shape[-1]))
    inv = np.argsort(_dcn_offset_perm(value.shape[-1], k))
    return (_conv_weight(value) if value.ndim == 4 else value)[inv]


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


# the JAX heads' final convs -> mmdet's names; the JAX FCOS-GFL head's
# atss_* convs are mmdet's conv_* and cannot be told from the ATSS head's
_HEAD_CONVS = {'gfl_cls': 'gfl_cls', 'gfl_reg': 'gfl_reg',
               'atss_cls': 'atss_cls', 'atss_reg': 'atss_reg',
               'atss_centerness': 'atss_centerness',
               'retina_cls': 'atss_cls', 'retina_reg': 'atss_reg',
               'reg_conf_1': 'reg_conf.0', 'reg_conf_2': 'reg_conf.2'}


def _head_key(path: tuple) -> str:
    leaf_name = {'kernel': 'weight', 'bias': 'bias'}
    m = re.fullmatch(r'(cls|reg)_conv(\d+)', path[0])
    if m is not None:
        kind, i = m.groups()
        if len(path) == 2:        # the Retina towers' bare biased convs
            return f'{kind}_convs.{i}.conv.{leaf_name[path[1]]}'
        sub, leaf = path[1:]
        if sub == 'Conv_0' and leaf == 'kernel':
            return f'{kind}_convs.{i}.conv.weight'
        if sub == 'GroupNorm_0':
            return f'{kind}_convs.{i}.gn.' + {'scale': 'weight',
                                              'bias': 'bias'}[leaf]
        raise KeyError(path)
    if path[0] in _HEAD_CONVS and len(path) == 2:
        return f'{_HEAD_CONVS[path[0]]}.{leaf_name[path[1]]}'
    raise KeyError(path)


def _avg_down(variables: Dict, keys: Optional[Iterable[str]]) -> bool:
    """Whether the backbone's shortcuts pool before their conv (mmdet's
    `downsample.{1,2}` names). The JAX tree does not say so for a ResNet:
    the target's own `keys` do. Without them: a Res2Net tree (whose blocks
    hold `convs0`) always pools, any other tree does not."""
    if keys is not None:
        return any(k.startswith('backbone.') and '.downsample.2.' in k
                   for k in keys)
    return any('convs0' in block for block in
               variables['params'].get('backbone', {}).values()
               if isinstance(block, dict))


def state_dict_from_jax(variables: Dict,
                        keys: Optional[Iterable[str]] = None
                        ) -> 'OrderedDict[str, torch.Tensor]':
    """JAX {'params', 'batch_stats'} tree (numpy leaves) -> the port's
    mmdet-named state dict, including each BatchNorm's
    `num_batches_tracked` (0), so `load_state_dict(strict=True)` accepts it.
    `keys`, the target model's state-dict keys, tell the shortcut layout
    (`_avg_down`).

    Raises KeyError on a leaf outside the ResNet / Res2Net / FPN / GFL-head
    families.
    """
    sd: Dict[str, np.ndarray] = {}
    params = variables['params']
    avg_down = _avg_down(variables, keys)
    num_laterals = sum(1 for k in params.get('neck', {})
                       if k.startswith('lateral_'))
    for coll in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(coll, {})):
            scope, rest = path[0], path[1:]
            if scope == 'backbone':
                key = 'backbone.' + _backbone_key(rest, avg_down)
                if rest[-2:] == ('bn', 'scale'):
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
                dcn = _dcn_value(params['backbone'], rest, value) \
                    if coll == 'params' else None
                if dcn is not None:
                    sd[key] = dcn
                    continue
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
    model.load_state_dict(state_dict_from_jax(
        variables, model.state_dict().keys()), strict=True)
    if teacher_variables is not None:
        model.teacher.load_state_dict(state_dict_from_jax(
            teacher_variables, model.teacher.state_dict().keys()),
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


def read_state_dict(path: str, keys: Optional[Iterable[str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """The state dict in a `.pth` (an mmdet checkpoint, a train state of
    `save_checkpoint`, or a bare state dict) or in a JAX `.npz`; `keys`
    (the target's) name a JAX tree's shortcut layout."""
    if path.endswith('.npz'):
        return state_dict_from_jax(load_variables(path), keys)
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
