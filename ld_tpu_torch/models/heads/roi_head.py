"""The standard two-stage RoI head (bbox branch); port of
`ld_tpu/models/heads/roi_head.py:30-660`, NCHW.

  * `ConvFCBBoxHead`, under mmdet's `roi_head.bbox_head` names: `num_convs`
    shared 3x3 convs (`shared_convs.i.conv`, with `.gn` and no bias under a
    GN `norm_cfg`, weight-standardized under a ConvWS `conv_cfg`), then
    `num_fcs` shared Linear + ReLU (`shared_fcs.i`), then
    `fc_cls` (C + 1 logits, the last background) and `fc_reg` (4 x C deltas,
    4 class-agnostic). Shared2FCBBoxHead is (0, 2), Shared4Conv1FCBBoxHead
    (4, 1), the plain `BBoxHead` (0, 0) with `with_avg_pool`. A roi feature
    flattens CHW, as mmdet's; the JAX net flattens HWC, and
    `state_dict_from_jax` permutes fc1's rows.
  * `StandardRoIHead.sample_rois`: the gt boxes joined to each image's
    proposals (`add_gt_as_proposals`), MaxIoU assignment (0.5 / 0.5 / 0.5,
    no ignore band), the sampler's positives and negatives, then a fixed
    `num` rois an image in random order (positives first, then negatives,
    then the rest as invalid padding), with labels (background C) and
    `DeltaXYWHBBoxCoder` targets (stds 0.1, 0.1, 0.2, 0.2), or the raw gt
    boxes with `reg_decoded_bbox`.
  * `forward_train`: level-routed RoIAlign 7x7 of the sampled rois, the
    net, softmax CE over the valid rois (averaged over their count) and
    `loss_bbox` on the class's deltas of the positives (over 4 x their
    count), or on the decoded boxes against the gt (over the valid count).
  * `simple_test`: softmax scores of the proposals, the class-specific
    boxes decoded and clipped, and one class-aware `multiclass_nms` of the
    (roi, class) pairs: the pairs of the JAX package's one-hot layout, in
    its order, without that (R*C, C) matrix.
  * The mask branch (Mask R-CNN, `mask_head`): RoIAlign at the mask
    extractor's `output_size` (14) on the bbox extractor's strides, then
    `FCNMaskHead` (`mask_head.py`). In training, `loss_mask` where the
    batch has `gt_masks`, on the positive rois, each against its assigned
    gt's mask. The JAX head runs the tower on every sampled roi and
    weights the others by 0; here it runs on the first `max_pos` rois of
    each image, the sampler's cap on positives (128 of 512), where
    `sample_rois` has put them all: the same sum over the same rois, at a
    quarter of the work and with no host sync. A sampler without a cap
    (`PseudoSampler`) runs it on every roi. At test time a 4th output,
    (B, max_per_img, 28, 28) sigmoid masks of the detections in roi space,
    pooled on their boxes in the network input's coordinates.

  * GRoIE (`GenericRoIExtractor`, `ld_tpu/models/heads/roi_head.py:
    122-158, 436-463`) for the bbox and mask extractors: RoIAlign of every
    roi at every level, a shared `pre_module` on each (a k x k conv with
    bias, then ReLU), their sum (or concatenation), a `post_module` plugin
    (`GeneralizedAttention` in the configs), zeros for invalid rois; under
    `roi_head.{bbox,mask}_roi_extractor.{pre,post}_module.*`. The mask
    branch still runs on the positive slice.
  * Hard mining (`OHEMSampler`, `ScoreHLRSampler`,
    `ld_tpu/models/heads/roi_head.py:315-318, 548-578`): a preliminary pass
    without gradient extracts every candidate (the gts joined to the
    proposals), runs the bbox net and hands the sampler each candidate's
    CE at its assigned label (`loss`) and its largest foreground softmax
    probability (`scores`). ScoreHLR's negative label weights (`weights` of
    the sampled rois) scale the rois' classification weights.

  * The C4 configs' `shared_head` (`ResLayer`, `ld_tpu/models/heads/
    roi_head.py:180-218, 249-275, 410-434`): mmdet's ResNet stage
    `layer{stage + 1}` (R50's res5: 3 caffe bottlenecks 1024 -> 2048, the
    first at stride 2) run on the roi batch, weight-shared, its BNs always
    on their running statistics (as the JAX net, which applies it out of
    training mode), frozen under `requires_grad=False`; under
    `roi_head.shared_head.layer4.*`. The RoIAlign of the bbox extractor
    (14x14 on the stride-16 C4 map) goes through it to (R, 2048, 7, 7),
    then the avg-pooled `BBoxHead`. The mask branch of a C4 config (no
    `mask_roi_extractor`) pools at the bbox extractor's size and runs the
    same shared stage, its `FCNMaskHead` at the post-res5 size (7, its
    logits 14x14).
  * Deformable RoI pooling (`roi_layer` `DeformRoIPoolPack` /
    `ModulatedDeformRoIPoolPack`, the JAX `DeformRoIPoolNet`,
    `roi_head.py:87-117, 281-291, 436-457`): the plain level-routed
    RoIAlign first, then its (R, C x 7 x 7) features, flattened CHW,
    through `offset_fc` (Linear to `deform_fc_channels`, ReLU, Linear to 2
    x 7 x 7, the last zero at init) to each bin's (dx, dy), the roi pooled
    again with those offsets (`multi_level_roi_align_offsets`, x gamma),
    and with the modulated form times `mask_fc`'s sigmoid (Linear, ReLU,
    Linear to 7 x 7, the last zero at init: 0.5 at init); under
    `roi_head.bbox_roi_extractor.{offset_fc,mask_fc}.{0,2}`. One set of
    FCs serves every level, as in JAX (mmdet builds one a level: ROADMAP.md
    caveat 74). The mask branch pools plainly.

The sampler draws from the `torch.Generator` the caller passes in. A
`bbox_head` of type `SABLHead` makes the head a `SABLRoIHead`
(`sabl_roi_head.py`), which builds its own bbox head.
"""
from __future__ import annotations

import re
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.backbones.plugins import build_plugin
from ld_tpu_torch.models.backbones.resnet import (ARCH_SETTINGS, Bottleneck,
                                                  init_trunk_weights,
                                                  make_shortcut)
from ld_tpu_torch.models.layers import (lecun_normal_, make_conv, make_norm,
                                        norm_name)
from ld_tpu_torch.ops.boxes import bbox_overlaps
from ld_tpu_torch.ops.coder import build_coder
from ld_tpu_torch.ops.max_iou_assigner import MaxIoUAssigner
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.ops.roi_align import (multi_level_roi_align,
                                       multi_level_roi_align_offsets,
                                       roi_align)
from ld_tpu_torch.ops.samplers import build_sampler, uniform_keys
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .mask_head import FCNMaskHead


def _not_ported(what: str, item: str = 'Queue A, keys that still raise'):
    raise NotImplementedError(f'{what} is not ported to ld_tpu_torch yet '
                              f'(see ROADMAP.md {item})')


def convfc_shape(bbox_head: dict):
    """(num_convs, num_fcs) of a bbox_head config's type (or the explicit
    ConvFCBBoxHead fields), as `ld_tpu/models/heads/roi_head.py:167-184`."""
    t = bbox_head.get('type', 'Shared2FCBBoxHead')
    if t == 'BBoxHead':
        return 0, 0
    if t == 'ConvFCBBoxHead':
        return (bbox_head.get('num_shared_convs', 0),
                bbox_head.get('num_shared_fcs', 2))
    m = re.match(r'Shared(\d+)Conv(\d+)FCBBoxHead', t)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.match(r'Shared(\d+)FCBBoxHead', t)
    if m:
        return 0, int(m.group(1))
    _not_ported(f'bbox_head type {t!r}')


class ConvModule(nn.Module):
    """A 3x3 conv (biased unless normed, weight-standardized under a ConvWS
    `conv_cfg`) + optional norm + ReLU (mmcv ConvModule: `.conv`, `.gn`)."""

    def __init__(self, in_channels, out_channels, conv_cfg=None,
                 norm_cfg=None):
        super().__init__()
        self.conv = make_conv(conv_cfg, in_channels, out_channels, 3,
                              bias=norm_cfg is None)
        self.norm_name = None if norm_cfg is None else norm_name(norm_cfg)
        if norm_cfg is not None:
            self.add_module(self.norm_name, make_norm(norm_cfg, out_channels))

    def forward(self, x):
        x = self.conv(x)
        if self.norm_name is not None:
            x = getattr(self, self.norm_name)(x)
        return torch.relu(x)


class ConvFCBBoxHead(nn.Module):

    def __init__(self, num_classes, in_channels=256, roi_size=7,
                 num_convs=0, num_fcs=2, conv_out_channels=256,
                 fc_out_channels=1024, with_avg_pool=False,
                 reg_class_agnostic=False, conv_cfg=None, norm_cfg=None):
        super().__init__()
        # the JAX net's BN reads its running statistics in training too:
        # only GN is ported
        if norm_cfg is not None and norm_cfg.get('type') != 'GN':
            _not_ported(f"bbox_head norm_cfg {norm_cfg.get('type')!r}")
        self.num_classes = num_classes
        self.with_avg_pool = with_avg_pool
        c = in_channels
        self.shared_convs = nn.ModuleList()
        for _ in range(num_convs):
            self.shared_convs.append(ConvModule(c, conv_out_channels,
                                                conv_cfg, norm_cfg))
            c = conv_out_channels
        flat = c if with_avg_pool else c * roi_size * roi_size
        self.shared_fcs = nn.ModuleList()
        for _ in range(num_fcs):
            self.shared_fcs.append(nn.Linear(flat, fc_out_channels))
            flat = fc_out_channels
        self.fc_cls = nn.Linear(flat, num_classes + 1)
        self.fc_reg = nn.Linear(flat, 4 if reg_class_agnostic
                                else 4 * num_classes)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: lecun-normal convs and shared FCs,
        normal(0.01) `fc_cls`, normal(0.001) `fc_reg`, zero biases, GN 1 /
        0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    m.reset_parameters()
            nn.init.normal_(self.fc_cls.weight, 0.0, 0.01,
                            generator=generator)
            nn.init.normal_(self.fc_reg.weight, 0.0, 0.001,
                            generator=generator)

    def forward(self, x: torch.Tensor):
        """x (R, C, S, S) -> cls (R, num_classes + 1), reg (R, 4[*C])."""
        for conv in self.shared_convs:
            x = conv(x)
        x = x.mean(dim=(2, 3)) if self.with_avg_pool else x.flatten(1)
        for fc in self.shared_fcs:
            x = torch.relu(fc(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()


class ConvReLU(nn.Module):
    """A biased k x k conv, then ReLU (a GRoIE `pre_module`: mmcv's
    ConvModule `.conv`)."""

    def __init__(self, in_channels, out_channels=256, kernel_size=3,
                 padding=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=kernel_size // 2 if padding is None
                              else padding)

    def forward(self, x):
        return torch.relu(self.conv(x))


class GenericRoIExtractor(nn.Module):
    """GRoIE's all-level extractor of one branch (the JAX `GroIENet` with
    its all-level RoIAlign): (B, n) rois -> (B*n, C, S, S), float32."""

    def __init__(self, out_size: int, featmap_strides, in_channels: int,
                 aggregation: str = 'sum', pre_cfg=None, post_cfg=None):
        super().__init__()
        if aggregation not in ('sum', 'concat'):
            raise ValueError(f'GRoIE aggregation {aggregation!r}')
        self.out_size = out_size
        self.featmap_strides = tuple(featmap_strides)
        self.aggregation = aggregation
        self.pre_module = None
        c = in_channels
        if pre_cfg:
            self.pre_module = self._sub(pre_cfg, c)
            c = pre_cfg.get('out_channels', 256) \
                if pre_cfg.get('type', 'ConvModule') == 'ConvModule' else c
        if aggregation == 'concat':
            c *= len(self.featmap_strides)
        self.post_module = self._sub(post_cfg, c) if post_cfg else None

    @staticmethod
    def _sub(cfg: dict, in_channels: int) -> nn.Module:
        cfg = {k: v for k, v in cfg.items() if k != 'in_channels'}
        if cfg.get('type', 'ConvModule') == 'ConvModule':
            return ConvReLU(in_channels, cfg.get('out_channels', 256),
                            cfg.get('kernel_size', 3), cfg.get('padding'))
        return build_plugin(cfg, in_channels)

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            for m in (self.pre_module, self.post_module):
                if isinstance(m, ConvReLU):
                    lecun_normal_(m.conv.weight, generator)
                    nn.init.zeros_(m.conv.bias)
                elif m is not None:
                    m.init_weights(generator)

    def forward(self, feats, rois: torch.Tensor, roi_valid: torch.Tensor):
        b, n = rois.shape[:2]
        flat = rois.reshape(-1, 4)
        batch_idx = torch.arange(b, device=rois.device).repeat_interleave(n)
        levels = [roi_align(feats[lvl], flat, batch_idx, self.out_size,
                            1.0 / stride)
                  for lvl, stride in enumerate(self.featmap_strides)]
        if self.pre_module is not None:
            # one conv over the levels stacked on the batch
            levels = self.pre_module(torch.cat(levels)).split(b * n)
        agg = torch.cat(levels, dim=1) if self.aggregation == 'concat' \
            else sum(levels)
        if self.post_module is not None:
            agg = self.post_module(agg)
        return agg * roi_valid.reshape(-1, 1, 1, 1)


class DeformRoIPoolExtractor(nn.Module):
    """A `SingleRoIExtractor` with a deformable `roi_layer`: (B, n) rois ->
    (B*n, C, S, S), float32, zeros for invalid rois (the module docstring
    says how)."""

    def __init__(self, out_size: int, featmap_strides, in_channels: int,
                 deform_fc_channels: int = 1024, modulated: bool = False,
                 gamma: float = 0.1):
        super().__init__()
        self.out_size = out_size
        self.featmap_strides = tuple(featmap_strides)
        self.gamma = gamma
        flat = in_channels * out_size * out_size
        bins = out_size * out_size
        self.offset_fc = nn.Sequential(
            nn.Linear(flat, deform_fc_channels), nn.ReLU(inplace=True),
            nn.Linear(deform_fc_channels, 2 * bins))
        self.mask_fc = nn.Sequential(
            nn.Linear(flat, deform_fc_channels), nn.ReLU(inplace=True),
            nn.Linear(deform_fc_channels, bins), nn.Sigmoid()) \
            if modulated else None

    def init_weights(self, generator: torch.Generator):
        """The JAX net's: lecun-normal first Linears, zero second ones and
        biases (the offsets 0 at init, the modulation 0.5)."""
        with torch.no_grad():
            for fc in (self.offset_fc, self.mask_fc):
                if fc is None:
                    continue
                lecun_normal_(fc[0].weight, generator)
                for p in (fc[0].bias, fc[2].weight, fc[2].bias):
                    nn.init.zeros_(p)

    def forward(self, feats, rois: torch.Tensor, roi_valid: torch.Tensor):
        levels = feats[:len(self.featmap_strides)]
        s = self.out_size
        first = multi_level_roi_align(levels, rois, roi_valid, s,
                                      self.featmap_strides).flatten(1)
        offsets = self.offset_fc(first).view(-1, 2, s, s)
        out = multi_level_roi_align_offsets(levels, rois, roi_valid, offsets,
                                            s, self.featmap_strides,
                                            gamma=self.gamma)
        if self.mask_fc is not None:
            out = out * self.mask_fc(first).view(-1, 1, s, s)
        return out


class ResLayer(nn.Module):
    """The C4 configs' weight-shared ResNet stage over a roi batch (mmdet's
    `ResLayer` shared head; the module docstring says how)."""

    def __init__(self, depth=50, stage=3, stride=2, dilation=1,
                 style='caffe', norm_cfg=None, dtype=None, **kwargs):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        if block is not Bottleneck:
            _not_ported(f'a ResLayer shared head of depth {depth}')
        planes = 64 * 2**stage
        inplanes = planes * block.expansion // 2
        layers = []
        for b in range(stage_blocks[stage]):
            s = stride if b == 0 else 1
            downsample = make_shortcut(
                inplanes, planes * block.expansion, s, False, dtype, None,
                norm_cfg) if b == 0 else None
            layers.append(block(inplanes, planes, s, dilation, downsample,
                                None, norm_cfg, style, dtype))
            inplanes = planes * block.expansion
        self.layer_name = f'layer{stage + 1}'
        self.add_module(self.layer_name, nn.Sequential(*layers))
        if (norm_cfg or {}).get('requires_grad', True) is False:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.requires_grad_(False)

    def init_weights(self, generator: torch.Generator):
        init_trunk_weights(self, generator)

    def train(self, mode: bool = True):
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(R, C, S, S) roi features -> (R, 4 x planes, S / stride, ...),
        float32."""
        return getattr(self, self.layer_name)(x).float()


def build_roi_extractor(ext: dict, out_size: int, featmap_strides,
                        in_channels: int):
    """A `GenericRoIExtractor` of a GRoIE extractor config, a
    `DeformRoIPoolExtractor` of a deformable `roi_layer`, None for mmdet's
    `SingleRoIExtractor` (the level-routed `multi_level_roi_align`)."""
    kind = ext.get('type', 'SingleRoIExtractor')
    roi_layer = dict(ext.get('roi_layer') or {})
    layer = roi_layer.get('type', 'RoIAlign')
    if kind == 'SingleRoIExtractor' and layer in (
            'DeformRoIPoolPack', 'ModulatedDeformRoIPoolPack'):
        return DeformRoIPoolExtractor(
            out_size, featmap_strides, in_channels,
            roi_layer.get('deform_fc_channels', 1024),
            layer.startswith('Modulated'), roi_layer.get('gamma', 0.1))
    if layer != 'RoIAlign':
        _not_ported(f'roi_layer {layer!r}')
    if kind == 'SingleRoIExtractor':
        return None
    if kind != 'GenericRoIExtractor':
        _not_ported(f'RoI extractor {kind!r}')
    return GenericRoIExtractor(
        out_size, featmap_strides, ext.get('out_channels', in_channels),
        ext.get('aggregation', 'sum'), ext.get('pre_cfg'),
        ext.get('post_cfg'))


@HEADS.register_module()
class StandardRoIHead(nn.Module):

    def __init__(self, bbox_roi_extractor=None, bbox_head=None,
                 mask_roi_extractor=None, mask_head=None, shared_head=None,
                 train_cfg=None, test_cfg=None, dtype=None, **kwargs):
        super().__init__()
        bbox_head = dict(bbox_head or {})
        ext = dict(bbox_roi_extractor or {})
        roi_layer = dict(ext.get('roi_layer') or {})
        # as the JAX head: only output_size is read (ROADMAP.md caveat 18)
        self.roi_size = roi_layer.get('output_size', 7)
        self.featmap_strides = tuple(ext.get('featmap_strides',
                                             (4, 8, 16, 32)))
        self.shared_head = None
        self.feat_size = self.roi_size
        if shared_head is not None:
            sh = {k: v for k, v in shared_head.items()
                  if k not in ('type', 'pretrained')}
            self.shared_head = ResLayer(dtype=dtype, **sh)
            self.feat_size = -(-self.roi_size // sh.get('stride', 2))
        self.bbox_roi_extractor = build_roi_extractor(
            ext, self.roi_size, self.featmap_strides,
            ext.get('out_channels', 256) if self.shared_head is not None
            else bbox_head.get('in_channels', 256))
        if self.shared_head is not None and \
                self.bbox_roi_extractor is not None:
            # the JAX head skips the shared stage after such an extractor
            _not_ported('a shared head behind a GRoIE or deformable '
                        'extractor (no config sets one; ROADMAP.md caveat '
                        '74)')
        self.num_classes = bbox_head.get('num_classes', 80)
        self.reg_class_agnostic = bbox_head.get('reg_class_agnostic', False)
        self.reg_decoded_bbox = bbox_head.get('reg_decoded_bbox', False)
        self.coder = build_coder(bbox_head.get('bbox_coder') or dict(
            type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
            target_stds=[0.1, 0.1, 0.2, 0.2]))
        self.loss_cls = LOSSES.build(bbox_head.get('loss_cls') or dict(
            type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0))
        self.loss_bbox = LOSSES.build(bbox_head.get('loss_bbox') or dict(
            type='L1Loss', loss_weight=1.0))
        self.train_cfg = train_cfg or {}
        self.test_cfg = test_cfg or dict(
            score_thr=0.05, nms=dict(iou_threshold=0.5), max_per_img=100)
        a_cfg = dict(self.train_cfg.get('assigner', dict(
            type='MaxIoUAssigner', pos_iou_thr=0.5, neg_iou_thr=0.5,
            min_pos_iou=0.5)))
        a_cfg.pop('type', None)
        self.assigner = MaxIoUAssigner(**a_cfg)
        s_cfg = dict(self.train_cfg.get('sampler', dict(
            num=512, pos_fraction=0.25, add_gt_as_proposals=True)))
        self.num_samples = s_cfg.get('num', 512)
        self.add_gt_as_proposals = s_cfg.get('add_gt_as_proposals', True)
        self.sampler = build_sampler(
            dict(s_cfg, type=s_cfg.get('type', 'RandomSampler')),
            num=self.num_samples,
            pos_fraction=s_cfg.get('pos_fraction', 0.25))
        # OHEM / ScoreHLR read a preliminary pass's losses and scores
        self.hard_mining = type(self.sampler).__name__ in (
            'OHEMSampler', 'ScoreHLRSampler')
        self.bbox_head = self._build_bbox_head(bbox_head)
        self.mask_head = None
        self.mask_roi_extractor = None
        if mask_head is not None:
            self.mask_head = self._build_mask_head(
                dict(mask_head), mask_roi_extractor, dtype)

    def _build_bbox_head(self, bbox_head: dict) -> nn.Module:
        num_convs, num_fcs = convfc_shape(bbox_head)
        return ConvFCBBoxHead(
            self.num_classes, bbox_head.get('in_channels', 256),
            self.feat_size, num_convs, num_fcs,
            bbox_head.get('conv_out_channels', 256),
            bbox_head.get('fc_out_channels', 1024),
            bbox_head.get('with_avg_pool', False), self.reg_class_agnostic,
            bbox_head.get('conv_cfg'), bbox_head.get('norm_cfg'))

    def _build_mask_head(self, mh: dict, mext, dtype) -> FCNMaskHead:
        """`ld_tpu/models/heads/roi_head.py:330-348`: with a shared head and
        no mask extractor (C4), the mask rois pool at the bbox extractor's
        size and the mask head sees the shared stage's output size."""
        kind = mh.pop('type', 'FCNMaskHead')
        if kind != 'FCNMaskHead':
            _not_ported(f'mask head {kind!r}')
        mh.setdefault('num_classes', self.num_classes)
        if mext is None and self.shared_head is not None:
            self.mask_roi_size = self.roi_size
            mh.setdefault('roi_size', self.feat_size)
            return FCNMaskHead(dtype=dtype, **mh)
        mext = dict(mext or {})
        self.mask_roi_size = (mext.get('roi_layer') or {}).get(
            'output_size', 14)
        self.mask_roi_extractor = build_roi_extractor(
            mext, self.mask_roi_size, self.featmap_strides,
            mh.get('in_channels', 256))
        mh.setdefault('roi_size', self.mask_roi_size)
        return FCNMaskHead(dtype=dtype, **mh)

    @property
    def with_test_masks(self) -> bool:
        """Whether `simple_test` returns the detections' masks, a 4th
        output."""
        return self.mask_head is not None

    def init_weights(self, generator: torch.Generator):
        self.bbox_head.init_weights(generator)
        if self.mask_head is not None:
            self.mask_head.init_weights(generator)
        for m in (self.bbox_roi_extractor, self.mask_roi_extractor,
                  self.shared_head):
            if m is not None:
                m.init_weights(generator)

    def _shared(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.shared_head is None else self.shared_head(x)

    def _extract(self, feats: List[torch.Tensor], rois, roi_valid):
        if self.bbox_roi_extractor is not None:
            return self.bbox_roi_extractor(feats, rois, roi_valid)
        return self._shared(multi_level_roi_align(
            feats[:len(self.featmap_strides)], rois, roi_valid,
            self.roi_size, self.featmap_strides))

    # ---- training ----------------------------------------------------------
    def sample_rois(self, proposals, prop_valid, gt_bboxes, gt_labels,
                    gt_valid, generator: torch.Generator, assigner=None,
                    coder=None, extras=None) -> Dict:
        """Assign and sample a fixed set of `num` rois an image.

        Args:
            proposals: (B, P, 4); prop_valid: (B, P); the gts (B, G, ...).
            assigner, coder: in place of the head's own (a cascade stage's).
            extras: the hard-mining samplers' inputs (`hard_mining_extras`).
        Returns:
            dict of rois (B, n, 4), roi_valid, roi_pos (B, n), labels (B, n),
            targets (B, n, 4) (deltas, or the gt boxes with
            `reg_decoded_bbox`), gt_inds (B, n) (each roi's assigned gt, 0
            where none), and where the sampler weights the negatives (B, n)
            `weights` (1 on the positives). The positives come first in
            each image.
        """
        if self.add_gt_as_proposals:
            proposals = torch.cat([gt_bboxes, proposals], dim=1)
            prop_valid = torch.cat([gt_valid, prop_valid], dim=1)
        res = (assigner or self.assigner).assign(
            proposals, None, gt_bboxes, gt_labels, gt_valid, prop_valid,
            num_classes=self.num_classes)
        raw_iou = torch.where(gt_valid[:, None, :],
                              bbox_overlaps(proposals, gt_bboxes),
                              torch.zeros((), device=proposals.device)
                              ).amax(dim=-1)
        pos_sel, neg_sel, neg_w = self.sampler.sample(
            generator, res.pos_mask & prop_valid,
            ~res.pos_mask & prop_valid, gt_inds=res.assigned_gt_inds,
            max_overlaps=raw_iou, boxes=proposals, **(extras or {}))
        sel = pos_sel | neg_sel
        rank_keys = pos_sel.float() + sel.float() + \
            uniform_keys(generator, sel) * 0.5
        n = min(self.num_samples, rank_keys.shape[1])
        order = torch.topk(rank_keys, n, dim=-1).indices

        def take(x):
            return torch.gather(x, 1, order)
        rois = torch.gather(proposals, 1, order[..., None].expand(-1, -1, 4))
        roi_pos = take(pos_sel)
        safe = take(res.assigned_gt_inds.clamp(min=0))
        labels = torch.where(roi_pos, take(res.labels),
                             torch.full_like(safe, self.num_classes))
        gts = torch.gather(gt_bboxes, 1, safe[..., None].expand(-1, -1, 4))
        targets = gts if self.reg_decoded_bbox else \
            (coder or self.coder).encode(rois, gts)
        s = dict(rois=rois, roi_valid=take(sel), roi_pos=roi_pos,
                 labels=labels, targets=targets, gt_inds=safe)
        if neg_w is not None:
            s['weights'] = take(torch.where(pos_sel, torch.ones_like(neg_w),
                                            neg_w))
        return s

    def hard_mining_extras(self, feats, proposals, prop_valid, batch
                           ) -> Dict[str, torch.Tensor]:
        """The OHEM / ScoreHLR inputs of every candidate (the gts joined to
        the proposals), (B, N) each, without gradient: `loss`, the CE of
        the bbox net's logits at the assigned label (the background where
        none), and `scores`, the largest foreground softmax probability."""
        gtb, gtl, gtv = (batch['gt_bboxes'], batch['gt_labels'].long(),
                         batch['gt_valid'])
        with torch.no_grad():
            cand, cv = proposals, prop_valid
            if self.add_gt_as_proposals:
                cand = torch.cat([gtb, proposals], dim=1)
                cv = torch.cat([gtv, prop_valid], dim=1)
            b, n = cand.shape[:2]
            cls, _ = self.bbox_head(self._extract(feats, cand, cv))
            res = self.assigner.assign(cand, None, gtb, gtl, gtv, cv,
                                       num_classes=self.num_classes)
            lab = torch.where(res.pos_mask, res.labels,
                              torch.full_like(res.labels, self.num_classes))
            ce = -torch.gather(F.log_softmax(cls, dim=-1), 1,
                               lab.reshape(-1, 1))[:, 0]
            scores = F.softmax(cls, dim=-1)[:, :self.num_classes].amax(-1)
        return dict(loss=ce.reshape(b, n), scores=scores.reshape(b, n))

    def _select_reg(self, reg, labels):
        if self.reg_class_agnostic:
            return reg
        reg = reg.reshape(-1, self.num_classes, 4)
        safe = labels.clamp(0, self.num_classes - 1)
        return torch.gather(reg, 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]

    def bbox_losses(self, cls, reg, s) -> Dict[str, torch.Tensor]:
        """CE over the valid rois and the regression of the positives
        (`ld_tpu/models/heads/roi_head.py:500-527`)."""
        labels = s['labels'].reshape(-1)
        validf = s['roi_valid'].reshape(-1).to(torch.float32)
        posf = s['roi_pos'].reshape(-1).to(torch.float32)
        avg = global_sum(validf.sum()).clamp(min=1.0)
        weight = validf if 'weights' not in s else \
            validf * s['weights'].reshape(-1)
        loss_cls = self.loss_cls(cls, labels, weight=weight, avg_factor=avg)
        reg_sel = self._select_reg(reg, labels)
        tgt = s['targets'].reshape(-1, 4)
        if self.reg_decoded_bbox:
            # negatives and padding parked at their target, as in JAX
            decoded = self.coder.decode(s['rois'].reshape(-1, 4), reg_sel)
            decoded = torch.where(posf[:, None] > 0, decoded, tgt)
            loss_bbox = self.loss_bbox(decoded, tgt, weight=posf,
                                       avg_factor=avg)
        else:
            loss_bbox = self.loss_bbox(
                reg_sel, tgt, weight=posf[:, None].expand(-1, 4),
                avg_factor=global_sum(posf.sum()).clamp(min=1.0) * 4.0)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        extras = self.hard_mining_extras(feats, proposals, prop_valid,
                                         batch) if self.hard_mining else None
        s = self.sample_rois(proposals, prop_valid, batch['gt_bboxes'],
                             batch['gt_labels'].long(), batch['gt_valid'],
                             generator, extras=extras)
        cls, reg = self.bbox_head(self._extract(feats, s['rois'],
                                                s['roi_valid']))
        losses = self.bbox_losses(cls, reg, s)
        if self.mask_head is not None and 'gt_masks' in batch:
            losses['loss_mask'] = self.mask_loss(feats, s, batch['gt_masks'])
        return losses

    def _mask_feats(self, feats, rois, valid):
        if self.mask_roi_extractor is not None:
            return self.mask_roi_extractor(feats, rois, valid)
        return self._shared(multi_level_roi_align(
            feats[:len(self.featmap_strides)], rois, valid,
            self.mask_roi_size, self.featmap_strides))

    def positive_slice(self, s: Dict) -> Dict:
        """The first `max_pos` rois of each image of the sampled rois `s`,
        where `sample_rois` has put every positive (all of them where the
        sampler sets no cap)."""
        cap = getattr(self.sampler, 'max_pos', None)
        n = s['rois'].shape[1] if cap is None else \
            min(cap, s['rois'].shape[1])
        return {k: v[:, :n] for k, v in s.items()}

    def mask_loss(self, feats, s: Dict, gt_masks, head=None) -> torch.Tensor:
        """`loss_mask` of the sampled rois `s` (`sample_rois`) against the
        batch's gt masks (B, G, H/4, W/4), on their positive slice, by
        `head` (the head's own mask head by default)."""
        s = self.positive_slice(s)
        head = self.mask_head if head is None else head
        return head.loss(
            self._mask_feats(feats, s['rois'], s['roi_pos']), s['rois'],
            s['roi_pos'], s['labels'], s['gt_inds'], gt_masks)

    # ---- inference ---------------------------------------------------------
    def simple_test(self, feats, proposals, prop_valid, img_hw,
                    scale_factor=None, rescale=False, cfg=None,
                    keep_fn=nms_keep):
        """(dets (B, max_per_img, 5), labels, valid) of the proposals, and
        with a mask head their masks (B, max_per_img, 28, 28)."""
        cfg = cfg or self.test_cfg
        b, r = proposals.shape[:2]
        cls, reg = self.bbox_head(self._extract(feats, proposals,
                                                prop_valid))
        scores = F.softmax(cls, dim=-1)[:, :self.num_classes].reshape(
            b, r, -1) * prop_valid[..., None]
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32,
                                 device=proposals.device)
        if self.reg_class_agnostic:
            boxes = self.coder.decode(proposals, reg.reshape(b, r, 4),
                                      max_shape=img_hw)
            boxes = boxes[:, :, None].expand(-1, -1, self.num_classes, 4)
        else:
            boxes = self.coder.decode(
                proposals[:, :, None], reg.reshape(b, r, self.num_classes, 4),
                max_shape=img_hw)
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, None, :]
        nms_cfg = dict(cfg.get('nms', {}))
        dets, labels, valid = multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            nms_cfg.get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), nms_cfg=nms_cfg,
            keep_fn=keep_fn)
        if not self.with_test_masks:
            return dets, labels, valid
        return dets, labels, valid, self.simple_test_mask(
            feats, dets, labels, valid,
            scale_factor if rescale else None)

    def simple_test_mask(self, feats, dets, labels, valid,
                         scale_factor=None) -> torch.Tensor:
        """The detections' sigmoid masks (B, D, 28, 28), pooled on their
        boxes times `scale_factor` (the network input's coordinates)."""
        b, d = dets.shape[:2]
        boxes = dets[..., :4]
        if scale_factor is not None:
            boxes = boxes * torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, :]
        masks = self.predict_masks(self._mask_feats(feats, boxes, valid),
                                   labels)
        return masks.reshape(b, d, *masks.shape[-2:])

    def predict_masks(self, roi_feats, labels) -> torch.Tensor:
        return self.mask_head.predict(roi_feats, labels)


@HEADS.register_module()
class TridentRoIHead(StandardRoIHead):
    """The `StandardRoIHead` of TridentNet: as in JAX it only carries the
    branch knobs, since `TridentFasterRCNN` folds and slices the branches
    (`ld_tpu/models/heads/roi_head.py:790-800`). mmdet's
    `test_branch_idx=-1`, a merge of the three branches' detections, would
    slice nothing in JAX: it raises here (ROADMAP.md caveat 92)."""

    def __init__(self, num_branch=3, test_branch_idx=1, **kwargs):
        if test_branch_idx == -1:
            raise NotImplementedError(
                'TridentRoIHead test_branch_idx=-1 (the merge of every '
                'branch) is not in the JAX package, which would slice no '
                'branch (ROADMAP.md caveat 92)')
        super().__init__(**kwargs)
        self.num_branch = num_branch
        self.test_branch_idx = test_branch_idx
