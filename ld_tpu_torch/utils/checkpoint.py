"""Weights in and out of the port.

  * `load_checkpoint`: a published mmdet `.pth` (or a bare state dict, or a
    JAX `.npz`) loads straight into the port's modules with
    `load_state_dict(strict=True)`, because the port uses mmdet's module
    names.
  * `state_dict_from_jax`: the exact inverse of
    `ld_tpu.utils.checkpoint.convert_torch_state_dict` for the ResNet /
    ResNeXt (with DCN stages) / FPN
    and the GFL, GFocalV2, ATSS-GFL, FCOS-GFL and Retina-GFL heads (an LD
    head has its base head's parameters; the JAX FCOS-GFL head's final
    convs carry the ATSS head's names, and the target's keys tell them
    apart). It also maps what that converter does not carry: the plain
    Retina / FCOS / ATSS heads (with `dcn_on_last_conv` towers), the RPN
    head and the RoI head's ConvFC net. It takes
    the JAX package's {'params', 'batch_stats'} tree as nested dicts of
    numpy arrays and returns the port's mmdet-named state dict, so both
    packages can run on the same weights. It also maps the deep stem, the
    avg-down shortcut and Res2Net (DCN splits too), which that converter
    leaves unmapped or mis-maps (ROADMAP.md Queue C, caveat 16): for those
    it is the only way weights cross between the packages. So it is for the
    ResNet's GCNet / attention plugins and its GroupNorms (`gnX`), the
    FPN's norms (`lateral_convs.I.gn`), which that converter has no rule
    for either; a weight-standardized conv's kernel goes across as a plain
    conv's.
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


def _module_name(name: str, avg_down: bool, norm: str = 'bn') -> str:
    """A JAX backbone module's name -> mmdet's: `normX` -> `bnX` (`gnX`
    for a GroupNorm, `norm` 'gn'), the deep
    stem's `stem_convI` / `stem_normI` -> `stem.{3(I-1)}` / `stem.{3I-2}`,
    Res2Net's `convsI` / `bnsI` -> `convs.I` / `bns.I`, and the shortcut's
    `downsample_conv` / `downsample_norm` -> `downsample.{0,1}`, or, behind
    an avg-down pool, `downsample.{1,2}`; RegNet's flat `layerS_B_<name>`
    -> `layerS.B.<name>`; HRNet's `transitionS_I[_downJ]_conv|norm` ->
    `transitionS.I[.J].{0,1}` and `fuseI_J[_downK]_conv|norm` ->
    `fuse_layers.I.J[.K].{0,1}`."""
    m = re.fullmatch(r'stem_(conv|norm)(\d)', name)
    if m is not None:
        return f'stem.{3 * (int(m.group(2)) - 1) + (m.group(1) == "norm")}'
    m = re.fullmatch(r'(convs|bns)(\d+)', name)
    if m is not None:
        return f'{m.group(1)}.{m.group(2)}'
    m = re.fullmatch(r'(layer\d)_(\d+)_(.+)', name)
    if m is not None:
        return f'{m.group(1)}.{m.group(2)}.' + _module_name(m.group(3),
                                                           avg_down, norm)
    m = re.fullmatch(r'(transition\d|fuse\d+)_(\d+)(?:_down(\d+))?_'
                     r'(conv|norm)', name)
    if m is not None:
        kind, i, j, layer = m.groups()
        kind = f'fuse_layers.{kind[4:]}' if kind.startswith('fuse') else kind
        return '.'.join([kind, i] + ([j] if j is not None else []) +
                        [str(int(layer == 'norm'))])
    shortcut = {'downsample_conv': 0, 'downsample_norm': 1}.get(name)
    if shortcut is not None:
        return f'downsample.{shortcut + avg_down}'
    if re.fullmatch(r'conv\d', name):
        return name
    m = re.fullmatch(r'norm([123])', name)
    if m is None:
        raise KeyError(name)
    return norm + m.group(1)


# the 1x1 convs of a DetectoRS SAConv2d, under mmcv's names
_SAC_CONVS = ('pre_context', 'switch', 'post_context')


def _backbone_key(path: tuple, avg_down: bool = False) -> str:
    """('conv1', 'kernel') / ('layer1_0', 'norm2', 'bn', 'scale') /
    ('layer3_0', 'conv2', 'conv_offset', 'bias') / ('layer2_0', 'conv2',
    'switch', 'kernel') / ... -> the mmdet
    ResNet / Res2Net / HRNet / RegNet name after 'backbone.'
    (`_block_prefix`, `_module_name`)."""
    *mods, leaf = path
    if mods[-1] in _SAC_CONVS:     # an SAConv2d's context / switch conv
        return '.'.join(_block_prefix(mods[:-2]) + [
            _module_name(mods[-2], avg_down), mods[-1],
            {'kernel': 'weight', 'bias': 'bias'}[leaf]])
    if mods[-1] in ('bn', 'gn'):   # BatchNorm / GroupNorm: .../normX/bn/<leaf>
        return '.'.join(_block_prefix(mods[:-2]) + [
            _module_name(mods[-2], avg_down, mods[-1]), _BN_LEAVES[leaf]])
    if leaf == 'conv2_kernel':     # a TridentBottleneck's shared 3x3
        return '.'.join(_block_prefix(mods) + ['conv2', 'weight'])
    if mods[-1] == 'conv_offset':  # a DCN conv's offset / mask conv
        return '.'.join(_block_prefix(mods[:-2]) + [
            _module_name(mods[-2], avg_down), 'conv_offset',
            {'kernel': 'weight', 'bias': 'bias'}[leaf]])
    if leaf != 'kernel':
        raise KeyError(path)
    return '.'.join(_block_prefix(mods[:-1]) + [
        _module_name(mods[-1], avg_down), 'weight'])


# the JAX plugins' scopes -> mmcv's module names
_PLUGIN_ABBR = {'context_block': 'context_block',
                'generalized_attention': 'gen_attention_block'}


def _plugin_value(rest: tuple, value: np.ndarray,
                  keys: Optional[List[str]]) -> Tuple[str, np.ndarray]:
    """A JAX ResNet block's plugin leaf, (`layerS_B`, `context_block[_I]` |
    `generalized_attention[_I]`, module..., leaf), -> its name after
    'backbone.' and its value in the port (`models/backbones/plugins.py`):
    a ContextBlock's `conv_mask`, `<fusion>_conv0` / `_ln` / `_conv1` to
    `conv_mask`, `<fusion>_conv.{0,1,3}` (the LayerNorm's (P,) to (P, 1,
    1)); a GeneralizedAttention's convs by name, its Dense kernels
    transposed, `appr_bias` / `geom_bias` (heads, d) flattened. The JAX
    scope `<type>_I` (I > 0, its index among the block's plugins) is the
    port's `<abbr>_I` where `keys` hold that name, else `<abbr>`."""
    block = '.'.join(_block_prefix(rest[:1]))
    m = re.fullmatch(r'(context_block|generalized_attention)(?:_(\d+))?',
                     rest[1])
    if m is None:
        raise KeyError(rest)
    name = _PLUGIN_ABBR[m.group(1)]
    if m.group(2) is not None and keys is not None and any(
            k.startswith(f'backbone.{block}.{name}_{m.group(2)}.')
            for k in keys):
        name = f'{name}_{m.group(2)}'
    return _plugin_module_value(f'{block}.{name}.', rest[2:-1], rest[-1],
                                value)


def _plugin_module_value(prefix: str, mod: tuple, leaf: str,
                         value: np.ndarray) -> Tuple[str, np.ndarray]:
    """A leaf (module..., leaf) of a JAX plugin under the port's `prefix`
    (`_plugin_value`)."""
    if not mod:                                 # gamma, appr / geom bias
        return prefix + leaf, value.reshape(-1)
    f = re.fullmatch(r'(channel_add|channel_mul)_(conv0|ln|conv1)', mod[0])
    if f is not None:
        sub = {'conv0': 0, 'ln': 1, 'conv1': 3}[f.group(2)]
        key = f'{prefix}{f.group(1)}_conv.{sub}.' + (
            'bias' if leaf == 'bias' else 'weight')
        if f.group(2) == 'ln':
            return key, value.reshape(-1, 1, 1)
        return key, _conv_weight(value) if leaf == 'kernel' else value
    key = prefix + mod[0] + ('.bias' if leaf == 'bias' else '.weight')
    if mod[0].startswith('appr_geom_fc'):
        return key, value.T
    return key, _conv_weight(value) if leaf == 'kernel' else value


def _block_prefix(owner) -> list:
    """A JAX block's scope -> mmdet's prefix: `layerS_B` -> `layerS.B`,
    HRNet's `stageS_moduleM` -> `stageS.M` and its `branchI_blockB` ->
    `branches.I.B`."""
    if not owner:
        return []
    m = re.fullmatch(r'layer(\d)_(\d+)', owner[0])
    if m is not None and len(owner) == 1:
        return [f'layer{m.group(1)}', m.group(2)]
    m = re.fullmatch(r'stage(\d)_module(\d+)', owner[0])
    if m is None or len(owner) > 2:
        raise KeyError(owner)
    prefix = [f'stage{m.group(1)}', m.group(2)]
    if len(owner) == 1:
        return prefix
    m = re.fullmatch(r'branch(\d+)_block(\d+)', owner[1])
    if m is None:
        raise KeyError(owner)
    return prefix + ['branches', m.group(1), m.group(2)]


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
    """An FPN's `lateral_I` / `fpn_conv_I` / `fpn_extra_I`, an HRFPN's
    `reduction` / `fpn_convI` -> mmdet's `lateral_convs.I.conv`,
    `fpn_convs.I.conv` (the extra convs after the laterals'),
    `reduction_conv.conv`; an FPN conv's norm, `<conv>_norm/gn|bn/<leaf>`,
    -> `<conv module>.gn|bn.<leaf>`."""
    mod, leaf = path[0], path[-1]
    m = re.fullmatch(r'(.+)_norm', mod)
    if m is not None:
        module = _neck_key((m.group(1), 'kernel'), num_laterals)
        return module[:-len('conv.weight')] + f'{path[1]}.{_BN_LEAVES[leaf]}'
    name = 'weight' if leaf == 'kernel' else 'bias'
    if mod == 'reduction':
        return f'reduction_conv.conv.{name}'
    m = re.fullmatch(r'fpn_conv(\d+)', mod)
    if m is not None:
        return f'fpn_convs.{m.group(1)}.conv.{name}'
    m = re.fullmatch(r'(lateral|fpn_conv|fpn_extra)_(\d+)', mod)
    if m is None:
        raise KeyError(path)
    kind, i = m.group(1), int(m.group(2))
    if kind == 'lateral':
        return f'lateral_convs.{i}.conv.{name}'
    if kind == 'fpn_extra':
        i += num_laterals
    return f'fpn_convs.{i}.conv.{name}'


_GN_LEAVES = {'scale': 'weight', 'bias': 'bias'}


def _extra_neck_key(path: tuple, neck: Dict) -> Optional[str]:
    """A leaf of the JAX package's other necks (`ld_tpu/models/necks/
    extra_necks.py`, `fpn.py:118-192`) -> the port's name after 'neck.'
    (`models/necks/extra_necks.py`, `fpn.py`), or None for an FPN / HRFPN
    leaf. Their laterals `lateralI` count from the first read level, the
    smallest I in the tree; a NAS-FCOS tree (with `cell0_conv`) numbers its
    extra convs `extraK` from 3."""
    mod, leaf = path[0], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias'}.get(leaf)
    m = re.fullmatch(r'lateral(\d+)', mod)
    if m is not None:
        first = min(int(k[len('lateral'):]) for k in neck
                    if re.fullmatch(r'lateral\d+', k))
        return f'lateral_convs.{int(m.group(1)) - first}.conv.{name}'
    m = re.fullmatch(r'extra(\d+)', mod)
    if m is not None:
        if 'cell0_conv' in neck:
            return f'extra_convs.{int(m.group(1)) - 3}.conv.{name}'
        return f'extra_downsamples.{m.group(1)}.0.conv.{name}'
    m = re.fullmatch(r's(\d+)_(\w+_\d\d_\d)', mod)     # a NAS-FPN cell
    if m is not None:
        return f'fpn_stages.{m.group(1)}.{m.group(2)}.out_conv.conv.{name}'
    m = re.fullmatch(r'upsample(\d+)', mod)              # a CARAFE
    if m is not None:
        return f'upsample_modules.{int(m.group(1)) - 1}.{path[1]}.{name}'
    m = re.fullmatch(r'cell(\d)_(conv|gn)', mod)         # NAS-FCOS
    if m is not None:
        return f'cells.{m.group(1)}.{m.group(2)}.' + (
            _GN_LEAVES[leaf] if m.group(2) == 'gn' else name)
    m = re.fullmatch(r's(\d+)_l(\d+)_(across|up|down)_(conv|gn)', mod)
    if m is not None:                                   # FPG
        s, lvl, kind, sub = m.groups()
        return f'stages.{s}.{lvl}.{kind}.{sub}.' + (
            _GN_LEAVES[leaf] if sub == 'gn' else name)
    m = re.fullmatch(r'aspp_s(\d+)_l(\d+)_b(\d)', mod)   # RFP
    if m is not None:
        s, lvl, b = (int(g) for g in m.groups())
        return f'rfp_aspp.{s - 1}.{lvl}.aspp.{b - 1}.{name}'
    m = re.fullmatch(r'nl_(g|theta|phi|out)', mod)         # BFP
    if m is not None:
        return f"refine.{'conv_out' if m.group(1) == 'out' else m.group(1)}" \
            f'.conv.{name}'
    if mod == 'refine':
        return f'refine.conv.{name}'
    m = re.fullmatch(r'(refine|gate)_s(\d+)_l(\d+)', mod)
    if m is not None:
        kind = {'refine': 'rfp_refine', 'gate': 'rfp_weight'}[m.group(1)]
        return f'{kind}.{int(m.group(2)) - 1}.{m.group(3)}.{name}'
    m = re.fullmatch(r'(downsample_conv|pafpn_conv|map)_(\d+)', mod)
    if m is not None:                                   # PAFPN, ChannelMapper
        kind, i = m.group(1), int(m.group(2))
        kind = {'map': 'convs'}.get(kind, kind + 's')
        return f'{kind}.{i - (kind == "pafpn_convs")}.conv.{name}'
    return None


def _neck_leaf(rest: tuple, neck: Dict, value: np.ndarray,
               sd: Dict[str, np.ndarray], prefix: str = 'neck.'
               ) -> Optional[str]:
    """A JAX neck leaf `rest` of the tree `neck` -> its port name, or None
    where it wrote the entry into `sd` itself: a stacked neck's child
    `necks_I` under `neck.I.`, RFP's own FPN under `fpn.`, the other necks
    (`_extra_neck_key`, CARAFE's encoder reordered), then the FPN / HRFPN
    (with a BN's `num_batches_tracked`)."""
    m = re.fullmatch(r'necks_(\d+)', rest[0])
    if m is not None:
        return _neck_leaf(rest[1:], neck[rest[0]], value, sd,
                          f'{prefix}{m.group(1)}.')
    if rest[0] == 'fpn':                                # RFP's own FPN
        return prefix + 'fpn.' + _neck_key(rest[1:], sum(
            1 for k in neck['fpn'] if re.fullmatch(r'lateral_\d+', k)))
    extra = _extra_neck_key(rest, neck)
    if extra is not None:
        if rest[1:2] != ('content_encoder', ):
            return prefix + extra
        enc = _carafe_encoder(value)
        sd[prefix + extra] = _conv_weight(enc) if value.ndim == 4 else enc
        return None
    key = prefix + _neck_key(rest, sum(
        1 for k in neck if re.fullmatch(r'lateral_\d+', k)))
    if rest[-2:] == ('bn', 'scale'):
        sd[key[:-len('weight')] + 'num_batches_tracked'] = \
            np.zeros((), np.int64)
    return key


# the JAX GRoIE trees -> the port's extractors
_GROIE = {'groie': 'bbox_roi_extractor', 'groie_mask': 'mask_roi_extractor',
          'groie_grid': 'grid_roi_extractor'}


def _carafe_encoder(value: np.ndarray, scale: int = 2) -> np.ndarray:
    """A JAX CARAFE `content_encoder` kernel / bias, its s*s*k^2 outputs in
    (s, s, k^2) order, -> mmcv's pixel-shuffle order (k^2, s, s)."""
    lead = value.shape[:-1]
    v = value.reshape(*lead, scale * scale, -1)
    return np.swapaxes(v, -1, -2).reshape(value.shape)


# the JAX heads' final convs -> mmdet's names; the JAX FCOS-GFL head's
# atss_* convs are mmdet's conv_* (`_FCOS_CONVS`), told from the ATSS head's
# by the target's keys alone
_HEAD_CONVS = {'gfl_cls': 'gfl_cls', 'gfl_reg': 'gfl_reg',
               'atss_cls': 'atss_cls', 'atss_reg': 'atss_reg',
               'atss_centerness': 'atss_centerness',
               'retina_cls': 'atss_cls', 'retina_reg': 'atss_reg',
               'conv_cls': 'conv_cls', 'conv_reg': 'conv_reg',
               'conv_centerness': 'conv_centerness',
               'reg_conf_1': 'reg_conf.0', 'reg_conf_2': 'reg_conf.2',
               'vfnet_reg': 'vfnet_reg', 'vfnet_reg_refine': 'vfnet_reg_refine',
               'vfnet_cls': 'vfnet_cls',
               # GA: the location and shape convs, the adaptions' offset
               # convs, the predictions
               'conv_loc': 'conv_loc', 'conv_shape': 'conv_shape',
               'offset_cls': 'feature_adaption_cls.conv_offset',
               'offset_reg': 'feature_adaption_reg.conv_offset',
               'ga_cls': 'retina_cls', 'ga_reg': 'retina_reg',
               # RepPoints
               'pts_init_conv': 'reppoints_pts_init_conv',
               'pts_init_out': 'reppoints_pts_init_out',
               'cls_out': 'reppoints_cls_out',
               'pts_refine_out': 'reppoints_pts_refine_out',
               # FoveaBox-align's offset conv
               'align_offset': 'feature_adaption.conv_offset',
               # the SABL RetinaNet's bucket convs
               'retina_bbox_cls': 'retina_bbox_cls',
               'retina_bbox_reg': 'retina_bbox_reg'}
# the heads' caller-offset DeformConvs (a (3*3*C, O) kernel, rows tap-major)
# that do not keep their JAX name: GA's adaptions, RepPoints' two DCNs;
# VFNet's `*_dconv` keep theirs
_DCONV_NAMES = {'adapt_cls': 'feature_adaption_cls.conv_adaption',
                'adapt_reg': 'feature_adaption_reg.conv_adaption',
                'cls_dconv': 'reppoints_cls_conv',
                'pts_refine_dconv': 'reppoints_pts_refine_conv',
                'feature_align': 'feature_adaption.conv_adaption'}
_RPN_CONVS = ('rpn_conv', 'rpn_cls', 'rpn_reg')
_FCOS_CONVS = dict(_HEAD_CONVS, atss_cls='conv_cls', atss_reg='conv_reg',
                   atss_centerness='conv_centerness')
# the plain RetinaHead keeps mmdet's retina_* names
_RETINA_CONVS = dict(_HEAD_CONVS, retina_cls='retina_cls',
                     retina_reg='retina_reg')


def _head_key(path: tuple, convs: Dict[str, str] = _HEAD_CONVS) -> str:
    leaf_name = {'kernel': 'weight', 'bias': 'bias'}
    m = re.fullmatch(r'(cls|reg)_conv(\d+)', path[0])
    block = None
    if m is not None:
        kind, i = m.groups()
        if len(path) == 2:        # the Retina towers' bare biased convs
            return f'{kind}_convs.{i}.conv.{leaf_name[path[1]]}'
        block = f'{kind}_convs.{i}'
    elif path[0] == 'vfnet_reg_conv':   # VFNet's conv + GN block
        block = path[0]
    if block is not None:
        sub, leaf = path[1], path[-1]
        if sub == 'Conv_0' and leaf == 'kernel':
            return f'{block}.conv.weight'
        if sub == 'ModulatedDeformConv_0':   # dcn_on_last_conv
            return f'{block}.conv.' + (
                f'conv_offset.{leaf_name[leaf]}' if 'conv_offset' in path
                else 'weight')
        if sub == 'GroupNorm_0':
            return f'{block}.gn.' + {'scale': 'weight', 'bias': 'bias'}[leaf]
        raise KeyError(path)
    if path[0] in convs and len(path) == 2:
        return f'{convs[path[0]]}.{leaf_name[path[1]]}'
    raise KeyError(path)


def _sepbn_norm_key(path: tuple) -> str:
    """('cls_norm_l{L}_d{I}', 'bn', leaf) -> `cls_convs.L.I.bn.<leaf>`."""
    m = re.fullmatch(r'(cls|reg)_norm_l(\d+)_d(\d+)', path[0])
    kind, lvl, i = m.groups()
    return f'{kind}_convs.{lvl}.{i}.bn.{_BN_LEAVES[path[-1]]}'


def _rpn_key(path: tuple) -> str:
    """('rpn_conv' | 'rpn_cls' | 'rpn_reg', leaf) -> mmdet's RPNHead name."""
    mod, leaf = path
    if mod not in _RPN_CONVS:
        raise KeyError(path)
    return f'{mod}.' + {'kernel': 'weight', 'bias': 'bias'}[leaf]


def _roi_key(path: tuple) -> str:
    """('bbox' | 'stageS', 'fcI' | 'fc_cls' | 'fc_reg' | 'convI' |
    'convI_norm', leaf) -> mmdet's ConvFCBBoxHead name (`shared_fcs.{I-1}`,
    `shared_convs.{I-1}.conv` and `.gn`), after `S.` for a cascade stage."""
    m = re.fullmatch(r'bbox|stage(\d+)', path[0])
    if m is None:
        raise KeyError(path)
    stage = '' if m.group(1) is None else f'{m.group(1)}.'
    return stage + _convfc_key(path)


def _convfc_key(path: tuple) -> str:
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}[leaf]
    if mod in ('fc_cls', 'fc_reg'):
        return f'{mod}.{name}'
    m = re.fullmatch(r'(fc|conv)(\d+)(_norm)?', mod)
    if m is None:
        raise KeyError(path)
    kind, i, norm = m.groups()
    if kind == 'fc':
        return f'shared_fcs.{int(i) - 1}.{name}'
    return f'shared_convs.{int(i) - 1}.' + ('gn' if norm else 'conv') + \
        f'.{name}'


# HTC's mask net names -> FCNMaskHead's / HTCMaskHead's
_HTC_MASK = {'deconv': 'upsample', 'logits': 'conv_logits',
             'info_flow': 'conv_res.conv'}


def _mask_key(path: tuple) -> str:
    """('mask' | 'maskS', 'convI' | 'upsample' | 'conv_logits' | HTC's
    'deconv' | 'logits' | 'info_flow', leaf) -> mmdet's FCNMaskHead /
    HTCMaskHead name (`convs.I.conv`, `upsample`, `conv_logits`,
    `conv_res.conv`), after `S.` for a cascade stage."""
    m = re.fullmatch(r'mask(\d*)', path[0])
    if m is None:
        raise KeyError(path)
    stage = f'{m.group(1)}.' if m.group(1) else ''
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias'}[leaf]
    m = re.fullmatch(r'conv(\d+)', mod)
    if m is not None:
        return f'{stage}convs.{int(m.group(1))}.conv.{name}'
    mod = _HTC_MASK.get(mod, mod)
    if mod not in ('upsample', 'conv_logits', 'conv_res.conv'):
        raise KeyError(path)
    return f'{stage}{mod}.{name}'


def _semantic_key(path: tuple) -> str:
    """('semantic', 'lateralI' | 'convI' | 'seg' | 'feat', leaf) -> mmdet's
    FusedSemanticHead name (`lateral_convs.I.conv`, `convs.I.conv`,
    `conv_logits`, `conv_embedding.conv`)."""
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias'}[leaf]
    m = re.fullmatch(r'(lateral|conv)(\d+)', mod)
    if m is not None:
        kind = 'lateral_convs' if m.group(1) == 'lateral' else 'convs'
        return f'{kind}.{m.group(2)}.conv.{name}'
    mod = {'seg': 'conv_logits', 'feat': 'conv_embedding.conv'}.get(mod)
    if mod is None:
        raise KeyError(path)
    return f'{mod}.{name}'


def _grid_point_value(path: tuple, value: np.ndarray
                      ) -> Tuple[str, np.ndarray]:
    """A Grid R-CNN grid net leaf (`grid`, `convI` | `gnI` | `deconv1` |
    `deconv2`, leaf) or a PointRend point MLP leaf (`point`, `fcI` |
    `logits`, leaf) -> its port name after 'roi_head.' (`grid_head.convs.
    I.conv` / `.gn`, `grid_head.deconvN`, the kernel flipped;
    `point_head.fcs.I.conv`, `point_head.fc_logits`, a (1, in, out) kernel
    to Conv1d's (out, in, 1)) and value."""
    net, mod, leaf = path
    name = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}[leaf]
    if net == 'grid':
        m = re.fullmatch(r'(conv|gn)(\d+)', mod)
        if m is not None:
            key = f'grid_head.convs.{m.group(2)}.{m.group(1)}.{name}'
            return key, _conv_weight(value) if value.ndim == 4 else value
        if mod not in ('deconv1', 'deconv2'):
            raise KeyError(path)
        return f'grid_head.{mod}.{name}', \
            _deconv_weight(value) if value.ndim == 4 else value
    m = re.fullmatch(r'fc(\d+)', mod)
    if m is None and mod != 'logits':
        raise KeyError(path)
    key = f'point_head.fcs.{m.group(1)}.conv.{name}' if m is not None \
        else f'point_head.fc_logits.{name}'
    return key, value.transpose(2, 1, 0) if value.ndim == 3 else value


def _deconv_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax ConvTranspose kernel (kh, kw, in, out) -> conv_transpose2d's
    (in, out, kh, kw): flax correlates where torch convolves, so the
    kernel flips in space."""
    return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))


def _dense_weight(path: tuple, kernel: np.ndarray, params: Dict
                  ) -> np.ndarray:
    """A JAX Dense kernel (in, out) -> a Linear weight (out, in). fc1 of the
    RoI net reads its (S, S, C) roi feature flattened HWC, mmdet's
    `shared_fcs.0` flattens CHW: its rows are permuted. C is the last shared
    conv's width, else the RPN's input width (the FPN's): its `rpn_conv`'s,
    a GA-RPN's first tower conv's, or a Cascade RPN's first adaptive
    conv's ((3*3*C, O) rows)."""
    weight = kernel.T
    if path[1] != 'fc1':
        return weight
    bbox = params['roi_head'][path[0]]
    convs = sorted((k for k in bbox if re.fullmatch(r'conv\d+', k)),
                   key=lambda k: int(k[4:]))
    if convs:
        c = np.shape(bbox[convs[-1]]['kernel'])[-1]
    else:
        rpn = params['rpn_net']
        if 'rpn' in rpn:
            return _chw_columns(weight, np.shape(
                rpn['rpn']['s1_adapt']['kernel'])[0] // 9)
        c = np.shape(rpn.get('rpn_conv', rpn.get('cls_conv0'))['kernel'])[2]
    return _chw_columns(weight, c)


def _chw_columns(weight: np.ndarray, c: int) -> np.ndarray:
    """A Linear weight (out, S*S*c) whose columns read an (S, S, c) input
    flattened HWC -> the same weight over the CHW flatten."""
    s = int(round((weight.shape[1] // c) ** 0.5))
    if s * s * c != weight.shape[1]:
        raise ValueError(f'{weight.shape[1]} inputs are not S x S x {c}')
    return weight.reshape(-1, s, s, c).transpose(0, 3, 1, 2).reshape(
        weight.shape[0], -1)


# the JAX SSD-VGG's convs -> mmdet's `features` indices (VGG-16 with its
# ReLUs and pools counted; a copy of the JAX converter's table)
_VGG16_FEATURES = {
    'conv1_0': 0, 'conv1_1': 2, 'conv2_0': 5, 'conv2_1': 7,
    'conv3_0': 10, 'conv3_1': 12, 'conv3_2': 14,
    'conv4_0': 17, 'conv4_1': 19, 'conv4_2': 21,
    'conv5_0': 24, 'conv5_1': 26, 'conv5_2': 28, 'fc6': 31, 'fc7': 33}


_SABL_INDEXED = {'cls_fc': 'cls_fcs.{}', 'reg_offset_fc': 'reg_offset_fcs.{}',
                 'reg_cls_fc': 'reg_cls_fcs.{}',
                 'reg_pre_conv': 'reg_pre_convs.{}.conv',
                 'reg_post_conv_x': 'reg_post_conv_xs.{}.conv',
                 'reg_post_conv_y': 'reg_post_conv_ys.{}.conv'}


def _sabl_value(path: tuple, value: np.ndarray, params: Dict
                ) -> Tuple[str, np.ndarray]:
    """('bbox' | 'stageS', module, leaf) of a JAX `SABLBBoxHeadNet` -> the
    port's `SABLBBoxHead` name (after `S.` for a cascade stage) and value:
    Dense kernels transposed, the one reading the flattened roi (`cls_fc1`,
    else `fc_cls`) from the HWC flatten to CHW, the 1-D post convs to (1, 3)
    / (3, 1) kernels, the upsamplings' kernels flipped (flax correlates)."""
    stage = re.fullmatch(r'bbox|stage(\d+)', path[0]).group(1)
    prefix = '' if stage is None else f'{stage}.'
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias'}[leaf]
    m = re.fullmatch(r'([a-z_]+?)(\d+)', mod)
    if m is not None and m.group(1) in _SABL_INDEXED:
        kind, i = m.group(1), int(m.group(2))
        key = _SABL_INDEXED[kind].format(i - 1 if kind.endswith('fc') else i)
    else:
        kind, key = mod, mod
    key = f'{prefix}{key}.{name}'
    if leaf != 'kernel':
        return key, value
    if value.ndim == 2:
        weight = value.T
        net = params['roi_head'][path[0]]
        if mod == 'cls_fc1' or (mod == 'fc_cls' and 'cls_fc1' not in net):
            rpn = params['rpn_net']
            c = np.shape(rpn.get('rpn_conv', rpn.get('cls_conv0'))[
                'kernel'])[2]
            weight = _chw_columns(weight, c)
        return key, weight
    if kind in ('upsample_x', 'upsample_y'):
        return key, np.ascontiguousarray(value[::-1].transpose(1, 2, 0))
    if kind == 'reg_post_conv_x':
        return key, value.transpose(2, 1, 0)[:, :, None, :]
    if kind == 'reg_post_conv_y':
        return key, value.transpose(2, 1, 0)[:, :, :, None]
    return key, _conv_weight(value)


def _is_sabl(params: Dict, path: tuple) -> bool:
    net = params.get('roi_head', {}).get(path[0])
    return isinstance(net, dict) and 'fc_reg_cls' in net


def _vgg_key(path: tuple) -> Optional[str]:
    """An SSD-VGG leaf (`convB_I`, `fc6`, `fc7`, `extraI_J`, `l2_norm`)
    -> mmdet's `features.N`, `extra.{2I + J - 1}`, `l2_norm.weight` after
    'backbone.', or None for any other backbone leaf."""
    mod, leaf = path[0], path[-1]
    if mod == 'l2_norm':
        return 'l2_norm.weight'
    name = {'kernel': 'weight', 'bias': 'bias'}.get(leaf)
    if mod in _VGG16_FEATURES:
        return f'features.{_VGG16_FEATURES[mod]}.{name}'
    m = re.fullmatch(r'extra(\d+)_([12])', mod)
    if m is not None:
        return f'extra.{2 * int(m.group(1)) + int(m.group(2)) - 1}.{name}'
    return None


# a ResNeSt split-attention conv's JAX scopes -> mmdet's
_SPLAT = {'conv': 'conv', 'norm0': 'bn0', 'fc1': 'fc1', 'norm1': 'bn1',
          'fc2': 'fc2'}


def _splat_key(path: tuple) -> Optional[str]:
    """A ResNeSt block's split-attention leaf, (`layerS_B`, 'conv2',
    `conv` | `normI` | `fcI`, ..., leaf), -> `layerS.B.conv2.<conv |
    bnI | fcI>.<leaf>` after 'backbone.', or None for any other leaf."""
    if len(path) < 4 or path[1] != 'conv2' or path[2] not in _SPLAT:
        return None
    leaf = path[-1]
    name = _BN_LEAVES[leaf] if path[3] == 'bn' else \
        {'kernel': 'weight', 'bias': 'bias'}[leaf]
    return '.'.join(_block_prefix(path[:1]) + ['conv2', _SPLAT[path[2]],
                                                name])


def _maskiou_key(path: tuple) -> str:
    """('maskiou', 'convI' | 'fcI' | 'fc_iou', leaf) -> mmdet's MaskIoUHead
    name (`convs.I.conv`, `fcs.I`, `fc_mask_iou`)."""
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias'}[leaf]
    m = re.fullmatch(r'(conv|fc)(\d+)', mod)
    if m is not None:
        kind = 'convs' if m.group(1) == 'conv' else 'fcs'
        return f'{kind}.{m.group(2)}' + ('.conv' if kind == 'convs' else '') \
            + f'.{name}'
    if mod != 'fc_iou':
        raise KeyError(path)
    return f'fc_mask_iou.{name}'


def _maskiou_dense(path: tuple, kernel: np.ndarray, params: Dict
                   ) -> np.ndarray:
    """A MaskIoU Dense kernel -> a Linear weight; fc0 reads the last conv's
    (S, S, C) output flattened HWC, mmdet's `fcs.0` flattens CHW: its rows
    are permuted."""
    if path[1] != 'fc0':
        return kernel.T
    return _chw_columns(kernel.T, np.shape(
        params['roi_head']['maskiou']['conv3']['kernel'])[-1])


def _dpool_value(path: tuple, value: np.ndarray, params: Dict
                 ) -> Tuple[str, np.ndarray]:
    """('dpool', 'offset_fc1' | 'offset_fc2' | 'mask_fc1' | 'mask_fc2',
    leaf) -> its name after `roi_head.bbox_roi_extractor.` and its value:
    `offset_fc.{0,2}` / `mask_fc.{0,2}`. The first Linears read the roi
    flattened HWC in JAX, CHW in the port (rows permuted); the JAX offsets
    come out (i, j, xy), the port's (xy, i, j) (mmcv's), so offset_fc2's
    outputs are reordered."""
    mod, leaf = path[1], path[-1]
    m = re.fullmatch(r'(offset|mask)_fc([12])', mod)
    if m is None:
        raise KeyError(path)
    name = f'{m.group(1)}_fc.{0 if m.group(2) == "1" else 2}.' + \
        {'kernel': 'weight', 'bias': 'bias'}[leaf]
    w = value.T if leaf == 'kernel' else value
    bins = np.shape(params['roi_head']['dpool']['offset_fc2']['bias'])[0] // 2
    if m.group(2) == '1' and leaf == 'kernel':
        w = _chw_columns(w, w.shape[1] // bins)
    elif mod == 'offset_fc2':
        s = int(round(bins ** 0.5))
        w = w.reshape(s, s, 2, -1).transpose(2, 0, 1, 3).reshape(
            w.shape) if w.ndim == 2 else \
            w.reshape(s, s, 2).transpose(2, 0, 1).reshape(-1)
    return name, w


def _double_head_value(path: tuple, value: np.ndarray, params: Dict
                       ) -> Tuple[str, np.ndarray]:
    """A JAX Double-Head net leaf (`roi_head/bbox` with `res_id`) -> its
    name after `roi_head.bbox_head.` and its value: `res_id` /
    `res_cN` / `res_nN` to `res_block.conv_identity.conv` /
    `res_block.convN.{conv,gn}`, `convI_cJ` / `convI_nJ` to
    `conv_branch.I.convJ` / `gnJ`, `fcI` to `fc_branch.I` (fc0's rows from
    the HWC flatten to CHW), `fc_cls`, `fc_reg`."""
    mod, leaf = path[1], path[-1]
    name = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}[leaf]
    if mod in ('fc_cls', 'fc_reg') or re.fullmatch(r'fc\d', mod):
        w = value.T if leaf == 'kernel' else value
        if mod == 'fc0' and leaf == 'kernel':
            w = _chw_columns(w, np.shape(
                params['roi_head']['bbox']['res_id']['kernel'])[2])
        key = mod if mod in ('fc_cls', 'fc_reg') else \
            f'fc_branch.{mod[2:]}'
        return f'{key}.{name}', w
    if mod == 'res_id':
        return 'res_block.conv_identity.conv.weight', _conv_weight(value)
    m = re.fullmatch(r'res_([cn])(\d)', mod)
    if m is not None:
        part = 'conv' if m.group(1) == 'c' else 'gn'
        return (f'res_block.conv{m.group(2)}.{part}.{name}',
                _conv_weight(value) if value.ndim == 4 else value)
    m = re.fullmatch(r'conv(\d+)_([cn])(\d)', mod)
    if m is None:
        raise KeyError(path)
    part = 'conv' if m.group(2) == 'c' else 'gn'
    return (f'conv_branch.{m.group(1)}.{part}{m.group(3)}.{name}',
            _conv_weight(value) if value.ndim == 4 else value)


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


def _conv_bn_leaf(rest: tuple) -> str:
    """A ConvBNLeaky's leaf (`conv/kernel`, `bn/bn/<leaf>`) -> mmcv's
    ConvModule suffix (`conv.weight`, `bn.<leaf>`)."""
    if rest[-2:] == ('conv', 'kernel'):
        return 'conv.weight'
    if rest[-3:-1] == ('bn', 'bn'):
        return 'bn.' + _BN_LEAVES[rest[-1]]
    raise KeyError(rest)


def _darknet_key(rest: tuple) -> str:
    """The JAX Darknet's `stem`, `down{S}`, `stage{S}_{B}/conv{I}` -> mmdet's
    `conv1`, `conv_res_block{S}.conv`, `conv_res_block{S}.res{B}.conv{I}`."""
    m = re.fullmatch(r'down(\d)', rest[0])
    if rest[0] == 'stem':
        prefix = 'conv1'
    elif m is not None:
        prefix = f'conv_res_block{m.group(1)}.conv'
    else:
        m = re.fullmatch(r'stage(\d)_(\d+)', rest[0])
        if m is None:
            raise KeyError(rest)
        prefix = f'conv_res_block{m.group(1)}.res{m.group(2)}.{rest[1]}'
    return f'{prefix}.{_conv_bn_leaf(rest)}'


def _yolo_neck_key(rest: tuple) -> str:
    """`detect{I}/conv{J}` and `lateral{I}` -> mmdet's `detect{I+1}.conv{J+1}`
    and `conv{I}`."""
    m = re.fullmatch(r'detect(\d)', rest[0])
    if m is not None:
        j = int(re.fullmatch(r'conv(\d)', rest[1]).group(1))
        return f'detect{int(m.group(1)) + 1}.conv{j + 1}.' + \
            _conv_bn_leaf(rest)
    m = re.fullmatch(r'lateral(\d)', rest[0])
    if m is None:
        raise KeyError(rest)
    return f'conv{m.group(1)}.' + _conv_bn_leaf(rest)


def _yolo_head_key(rest: tuple) -> str:
    """`bridge{I}` / `pred{I}` -> `convs_bridge.{I}` / `convs_pred.{I}`."""
    m = re.fullmatch(r'(bridge|pred)(\d)', rest[0])
    if m is None:
        raise KeyError(rest)
    if m.group(1) == 'pred':
        return f'convs_pred.{m.group(2)}.' + {'kernel': 'weight',
                                               'bias': 'bias'}[rest[-1]]
    return f'convs_bridge.{m.group(2)}.' + _conv_bn_leaf(rest)


_TOOD_CONVS = {'tood_cls': 'tood_cls', 'tood_reg': 'tood_reg',
               'cls_prob_conv1': 'cls_prob_module.0',
               'cls_prob_conv2': 'cls_prob_module.2',
               'reg_offset_conv1': 'reg_offset_module.0',
               'reg_offset_conv2': 'reg_offset_module.2',
               'la_conv1': 'layer_attention.0',
               'la_conv2': 'layer_attention.2'}


def _tood_value(rest: tuple, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """A JAX TOOD net's leaf -> (mmdet's name, value): `inter_conv{I}` ->
    `inter_convs.{I}.{conv,gn}`, a decomposition's `reduction_kernel`
    (sc x C, C) -> its 1x1 `reduction_conv.conv.weight` (a (1, 1, sc x C,
    C) HWIO kernel, transposed with the others),
    `reduction_gn` -> `reduction_conv.gn`, the branch convs by
    `_TOOD_CONVS`."""
    leaf = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}
    m = re.fullmatch(r'inter_conv(\d+)', rest[0])
    if m is not None:
        sub = 'conv' if rest[1] == 'Conv_0' else 'gn'
        return f'inter_convs.{m.group(1)}.{sub}.{leaf[rest[-1]]}', value
    if rest[0] in ('cls_decomp', 'reg_decomp'):
        if rest[1] == 'reduction_kernel':
            return f'{rest[0]}.reduction_conv.conv.weight', value[None, None]
        if rest[1] == 'reduction_gn':
            return f'{rest[0]}.reduction_conv.gn.{leaf[rest[-1]]}', value
        return f'{rest[0]}.{_TOOD_CONVS[rest[1]]}.{leaf[rest[-1]]}', value
    return f'{_TOOD_CONVS[rest[0]]}.{leaf[rest[-1]]}', value


# the JAX Cascade RPN net's convs -> mmdet's StageCascadeRPNHead names
_CRPN_CONVS = {'s1_adapt': 'stages.0.rpn_conv.conv',
               's1_reg': 'stages.0.rpn_reg',
               's2_adapt': 'stages.1.rpn_conv.conv',
               's2_cls': 'stages.1.rpn_cls', 's2_reg': 'stages.1.rpn_reg'}


def state_dict_from_jax(variables: Dict,
                        keys: Optional[Iterable[str]] = None
                        ) -> 'OrderedDict[str, torch.Tensor]':
    """JAX {'params', 'batch_stats'} tree (numpy leaves) -> the port's
    mmdet-named state dict, including each BatchNorm's
    `num_batches_tracked` (0), so `load_state_dict(strict=True)` accepts it.
    `keys`, the target model's state-dict keys, tell the shortcut layout
    (`_avg_down`) and an FCOS-GFL head (`bbox_head.conv_cls.*`, whose JAX
    convs are `atss_*`); without them the head's convs keep the ATSS names.

    The two-stage trees map too: `rpn_net` to `rpn_head.*`,
    `roi_head/bbox` to `roi_head.bbox_head.*` (Dense kernels transposed,
    fc1's rows from the JAX HWC flatten to mmdet's CHW) and `roi_head/mask`
    to `roi_head.mask_head.*` (the upsample's kernel flipped); a cascade's
    `roi_head/stageS` and `roi_head/maskS` (HTC's `info_flow` too) to
    `roi_head.bbox_head.S.*` and `roi_head.mask_head.S.*`, HTC's
    `roi_head/semantic` to `roi_head.semantic_head.*`; with
    `bbox_head.retina_cls.*` in `keys` the plain Retina head keeps its
    `retina_*` names. A VFNet head's `vfnet_*` convs, its star `*_dconv`
    kernels (3 x 3 taps) and its `scales_refine` vector map to mmdet's
    names (the JAX converter has no VFNet rule: ROADMAP.md caveat 45). A
    GA head's net (`conv_loc`, `conv_shape`, `offset_*`, `adapt_*`,
    `ga_*`), under `head_net` or, for a GA-RPN, `rpn_net`, maps to the
    port's GA names (`feature_adaption_*`, `retina_*`; caveat 47), and a
    RepPoints net (`pts_init_*`, `cls_dconv`, `cls_out`, `pts_refine_*`,
    `moment_transfer`) to mmdet's `reppoints_*` names; the JAX converter
    has no rule for either. So do a ResNeSt trunk (its split-attention
    `conv2/{conv, norm0, fc1, norm1, fc2}` to `conv2.{conv, bn0, fc1, bn1,
    fc2}`), an SSD-VGG (`convB_I`, `fc6`, `fc7`, `extraI_J`, `l2_norm` to
    `features.N`, `extra.N`, `l2_norm.weight`: the JAX converter's map
    inverted), an SSD head (its bare `cls_convI` / `reg_convI` to
    `cls_convs.I` / `reg_convs.I`, where `keys` hold those names), a
    FoveaBox head (`align_offset`, `feature_align` to
    `feature_adaption.{conv_offset, conv_adaption}`) and a MaskIoU head
    (`roi_head/maskiou` to `roi_head.mask_iou_head.*`, fc0's rows from the
    HWC flatten to CHW). A SABL RetinaNet head's `retina_bbox_cls` /
    `retina_bbox_reg` keep their names, and a SABL RoI net (`roi_head/bbox`,
    a cascade's `roi_head/stageS`; told by its `fc_reg_cls`) maps to the
    port's `SABLBBoxHead` names (`_sabl_value`); the JAX converter has no
    rule for either (ROADMAP.md caveat 58). Neither has it one for a
    DetectoRS SAConv (`conv2/{switch, pre_context, post_context}`), the
    other necks (`_extra_neck_key`: RFP, NAS-FPN, CARAFE, NAS-FCOS, FPG,
    PAFPN, ChannelMapper; CARAFE's encoder channels reordered,
    `_carafe_encoder`) or the Grid R-CNN and PointRend nets
    (`roi_head/grid`, `roi_head/point`, `_grid_point_value`), which map
    here too, nor for a stacked neck (`neck/necks_I/...` to `neck.I.*`,
    `_neck_leaf`), BFP (`nl_{g,theta,phi,out}` to mmcv's
    `refine.{g,theta,phi,conv_out}.conv`, a conv `refine` to
    `refine.conv`) or the GRoIE trees (`roi_head/groie`, `groie_mask`,
    `groie_grid` to the bbox, mask and grid extractors' `pre_module.conv`
    and `post_module`, the latter with the plugins' GeneralizedAttention
    names), nor for the C4 shared res5 (`roi_head/shared/{params,
    batch_stats}/layer4_B/...` to `roi_head.shared_head.layer4.B.*`, the
    backbone's names), deformable RoI pooling (`roi_head/dpool`,
    `_dpool_value`), the Double-Head net (`_double_head_value`) or SCNet's
    global context (`roi_head/glbctx/{fc1,fc_cls,fc_ctx}` to
    `roi_head.glbctx_head.*`), nor for Darknet (`_darknet_key`), the YOLOv3
    neck and head (`_yolo_neck_key`, `_yolo_head_key`), a TOOD head
    (`_tood_value`: the (sc x C, C) `reduction_kernel` to a 1x1 conv
    weight), a Cascade RPN (`rpn_net/rpn/*`, `_CRPN_CONVS`; its adaptive
    convs' (3*3*C, O) kernels) or a TridentBottleneck's shared
    `conv2_kernel` (to `conv2.weight`).

    Raises KeyError on a leaf outside the ResNet / Res2Net / FPN, the
    dense-head (GFL family, Retina, FCOS, ATSS, VFNet, GA, RepPoints),
    RPN, RoI-head and
    mask-head families.
    """
    sd: Dict[str, np.ndarray] = {}
    params = variables['params']
    keys = None if keys is None else list(keys)
    avg_down = _avg_down(variables, keys)
    head_convs = _HEAD_CONVS
    if keys is not None and any(k.startswith('bbox_head.conv_cls.')
                                for k in keys):
        head_convs = _FCOS_CONVS
    elif keys is not None and any(k.startswith('bbox_head.retina_cls.')
                                  for k in keys):
        head_convs = _RETINA_CONVS
    # an SSD head's per-level convs are bare convs (`cls_convs.i.weight`)
    ssd_head = keys is not None and 'bbox_head.cls_convs.0.weight' in keys
    # a RetinaSepBNHead's levels, from the target's keys
    sepbn_levels = len({k.split('.')[2] for k in keys or ()
                        if re.fullmatch(r'bbox_head\.cls_convs\.\d+\.0\.'
                                        r'conv\.weight', k)})
    for coll in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(coll, {})):
            scope, rest = path[0], path[1:]
            if scope == 'backbone' and len(rest) > 2 and rest[1].startswith(
                    ('context_block', 'generalized_attention')):
                key, value = _plugin_value(rest, value, keys)
                sd['backbone.' + key] = value
                continue
            if scope == 'backbone' and 'down1' in params['backbone']:
                key = 'backbone.' + _darknet_key(rest)
                if rest[-1] == 'scale':
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'backbone' and (_vgg_key(rest) or
                                          _splat_key(rest)):
                key = 'backbone.' + (_vgg_key(rest) or _splat_key(rest))
                if rest[-2:] == ('bn', 'scale'):
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'backbone':
                key = 'backbone.' + _backbone_key(rest, avg_down)
                if rest[-2:] == ('bn', 'scale'):
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
                dcn = _dcn_value(params['backbone'], rest, value) \
                    if coll == 'params' else None
                if dcn is not None:
                    sd[key] = dcn
                    continue
            elif scope == 'neck' and 'detect0' in params['neck']:
                key = 'neck.' + _yolo_neck_key(rest)
                if rest[-1] == 'scale':
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'neck':
                key = _neck_leaf(rest, params['neck'], value, sd)
                if key is None:
                    continue
            elif scope == 'head_net' and rest in (('scales', ),
                                                  ('scales_refine', )):
                for lvl, s in enumerate(value):
                    sd[f'bbox_head.{rest[0]}.{lvl}.scale'] = np.float32(s)
                continue
            elif scope == 'head_net' and 'bridge0' in params['head_net']:
                key = 'bbox_head.' + _yolo_head_key(rest)
                if rest[-1] == 'scale':
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'head_net' and 'cls_decomp' in params['head_net']:
                key, value = _tood_value(rest, value)
                key = 'bbox_head.' + key
            elif scope == 'rpn_net' and rest[0] == 'rpn':
                key = f'rpn_head.{_CRPN_CONVS[rest[1]]}.' + {
                    'kernel': 'weight', 'bias': 'bias'}[rest[2]]
                if rest[1].endswith('_adapt'):
                    sd[key] = _conv_weight(value.reshape(
                        3, 3, -1, value.shape[-1]))
                    continue
            elif scope in ('head_net', 'rpn_net') and rest[1:] == (
                    'kernel', ) and (rest[0] in _DCONV_NAMES or
                                     rest[0].endswith('_dconv')):
                # a caller-offset DeformConv (VFNet's star DCN, GA's
                # adaptions, RepPoints' DCNs): a (3*3*C, O) kernel, rows
                # tap-major (HWIO); a GA-RPN's under `rpn_head`
                head = 'bbox_head' if scope == 'head_net' else 'rpn_head'
                sd[f'{head}.{_DCONV_NAMES.get(rest[0], rest[0])}.weight'] = \
                    _conv_weight(value.reshape(3, 3, -1, value.shape[-1]))
                continue
            elif scope == 'head_net' and rest == ('moment_transfer', ):
                sd['bbox_head.moment_transfer'] = value
                continue
            elif scope == 'head_net' and re.fullmatch(
                    r'(cls|reg)_norm_l\d+_d\d+', rest[0]):
                key = 'bbox_head.' + _sepbn_norm_key(rest)
                if rest[-1] == 'scale':
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'head_net' and sepbn_levels and len(rest) == 2 \
                    and re.fullmatch(r'(cls|reg)_conv\d+', rest[0]):
                # a shared tower conv: one tensor under every level's name
                kind, i = rest[0].split('_conv')
                for lvl in range(sepbn_levels):
                    sd[f'bbox_head.{kind}_convs.{lvl}.{i}.conv.weight'] = \
                        _conv_weight(value)
                continue
            elif scope == 'head_net' and ssd_head and len(rest) == 2 and \
                    re.fullmatch(r'(cls|reg)_conv\d+', rest[0]):
                # an SSD head's bare per-level convs
                kind, i = rest[0].split('_conv')
                key = f'bbox_head.{kind}_convs.{i}.' + {
                    'kernel': 'weight', 'bias': 'bias'}[rest[1]]
            elif scope == 'head_net':
                key = 'bbox_head.' + _head_key(rest, head_convs)
                dcn = _dcn_value(params['head_net'], rest, value)
                if dcn is not None:
                    sd[key] = dcn
                    continue
            elif scope == 'rpn_net':
                # an RPNHead's convs, or a GA-RPN's GA-Retina net
                key = 'rpn_head.' + (_rpn_key(rest) if rest[0] in _RPN_CONVS
                                     else _head_key(rest))
            elif scope == 'roi_head' and rest[0] in _GROIE:
                key = f'roi_head.{_GROIE[rest[0]]}.'
                if rest[1] == 'post':
                    key, value = _plugin_module_value(
                        key + 'post_module.', rest[2:-1], rest[-1], value)
                    sd[key] = value
                    continue
                key += 'pre_module.conv.' + (
                    'bias' if rest[-1] == 'bias' else 'weight')
            elif scope == 'roi_head' and rest[0] == 'shared':
                # the C4 shared res5: its params and running statistics
                # both sit in the params tree, under `params` / `batch_stats`
                key = 'roi_head.shared_head.' + _backbone_key(rest[2:])
                if rest[-2:] == ('bn', 'scale'):
                    sd[key[:-len('weight')] + 'num_batches_tracked'] = \
                        np.zeros((), np.int64)
            elif scope == 'roi_head' and rest[0] == 'dpool':
                key, value = _dpool_value(rest, value, params)
                sd['roi_head.bbox_roi_extractor.' + key] = value
                continue
            elif scope == 'roi_head' and rest[0] == 'glbctx':
                sd[f'roi_head.glbctx_head.{rest[1]}.' + (
                    'weight' if rest[-1] == 'kernel' else 'bias')] = \
                    value.T if rest[-1] == 'kernel' else value
                continue
            elif scope == 'roi_head' and rest[0] == 'bbox' and \
                    'res_id' in params['roi_head']['bbox']:
                key, value = _double_head_value(rest, value, params)
                sd['roi_head.bbox_head.' + key] = value
                continue
            elif scope == 'roi_head' and rest[0] == 'semantic':
                key = 'roi_head.semantic_head.' + _semantic_key(rest)
            elif scope == 'roi_head' and rest[0] == 'maskiou':
                key = 'roi_head.mask_iou_head.' + _maskiou_key(rest)
                if rest[-1] == 'kernel' and value.ndim == 2:
                    sd[key] = _maskiou_dense(rest, value, params)
                    continue
            elif scope == 'roi_head' and rest[0] in ('grid', 'point'):
                key, value = _grid_point_value(rest, value)
                sd['roi_head.' + key] = value
                continue
            elif scope == 'roi_head' and rest[0].startswith('mask'):
                key = 'roi_head.mask_head.' + _mask_key(rest)
                if rest[1] in ('upsample', 'deconv') and \
                        rest[-1] == 'kernel':
                    sd[key] = _deconv_weight(value)
                    continue
            elif scope == 'roi_head' and _is_sabl(params, rest):
                key, value = _sabl_value(rest, value, params)
                sd['roi_head.bbox_head.' + key] = value
                continue
            elif scope == 'roi_head':
                key = 'roi_head.bbox_head.' + _roi_key(rest)
                if rest[-1] == 'kernel' and value.ndim == 2:
                    sd[key] = _dense_weight(rest, value, params)
                    continue
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
