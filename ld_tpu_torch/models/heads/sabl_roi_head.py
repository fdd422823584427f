"""The SABL two-stage heads; port of `ld_tpu/models/heads/roi_head.py:674-788`
(`SABLBBoxHeadNet`), `:802-935` (`SABLRoIHead`) and
`ld_tpu/models/heads/cascade_roi_head.py:244-393` (`CascadeSABLRoIHead`),
NCHW.

  * `SABLBBoxHead`: the cls branch, `num_cls_fcs` Linear + ReLU over the
    flattened roi (`cls_fcs.i`; CHW here, HWC in JAX: `state_dict_from_jax`
    permutes the first one's columns) and `fc_cls` (C + 1 logits); the reg
    branch, `reg_pre_num` 3x3 convs (`reg_pre_convs.i.conv`), the x / y
    attention (`reg_conv_att_x` / `_y`: a sigmoid 1x1, normalised over H for
    x and over W for y) pooling the map to one feature a column and a row,
    `reg_post_num` (1, 3) / (3, 1) convs along them (`reg_post_conv_xs.i.conv`
    / `_ys`), the `ConvTranspose1d` upsampling by `reg_feat_up_ratio`
    (`upsample_x` / `_y`; flax's kernel is not flipped, torch's is), then
    `fc_reg_offset` / `fc_reg_cls` (after `num_reg_fcs` Linear + ReLU each)
    shared by both axes, and the side split (the left half kept, the right
    half reversed): bucket logits and offsets (R, 4 x side_num) in the
    coder's side order l, r, t, d. The JAX structure under mmdet-like names;
    neither package's converter has a SABL rule (ROADMAP.md caveat 58).
  * `SABLRoIHead` (a `StandardRoIHead` whose `bbox_head` is a `SABLHead`,
    as the JAX router sends it): `sample_rois` with the matched gt boxes
    as targets, softmax CE over the valid rois, the `BucketingBBoxCoder`
    (14 buckets, 1.7) encode of each positive's gt, the bucket BCE and the
    offsets' SmoothL1 over the positives at count x 4 x side_num and
    count x 4 x offset_topk; at test the softmax scores times the bucket
    decode's confidence, the decode clipped to the image, one
    `multiclass_nms`. The mask branch is `StandardRoIHead`'s. The hard-mining
    samplers raise, as in JAX.
  * `CascadeSABLRoIHead`: one `SABLBBoxHead` and one bucketing coder a
    stage (scale factors 1.7 / 1.5 / 1.3 unless a stage's `bbox_coder`
    says otherwise) under `bbox_head.{i}`; the first stage's bucket losses
    serve every stage (as caveat 27's); each stage's rois are refined by its
    bucket decode, unclipped and detached; the test averages the stages'
    softmax and applies the last stage's decode and confidence.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_
from ld_tpu_torch.ops.coder import PseudoBBoxCoder, build_coder
from ld_tpu_torch.ops.nms import multiclass_nms
from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.parallel.dist import global_sum
from ld_tpu_torch.utils.registry import HEADS, LOSSES
from .cascade_roi_head import CascadeRoIHead
from .roi_head import ConvModule, StandardRoIHead, _not_ported

CASCADE_SCALE_FACTORS = (1.7, 1.5, 1.3)
_GT_TARGETS = PseudoBBoxCoder()


class _PostConv(nn.Module):
    """A biased (1, 3) or (3, 1) conv + ReLU along one axis (mmcv
    ConvModule: `.conv`)."""

    def __init__(self, channels, out_channels, kernel_size):
        super().__init__()
        padding = tuple(k // 2 for k in kernel_size)
        self.conv = nn.Conv2d(channels, out_channels, kernel_size,
                              padding=padding)

    def forward(self, x):
        return torch.relu(self.conv(x))


class SABLBBoxHead(nn.Module):

    def __init__(self, num_classes, side_num, in_channels=256, roi_size=7,
                 cls_out_channels=1024, reg_in_channels=256,
                 reg_feat_up_ratio=2, reg_pre_num=2, reg_post_num=1,
                 num_cls_fcs=1, num_reg_fcs=0, reg_offset_out_channels=256,
                 reg_cls_out_channels=256):
        super().__init__()
        self.num_classes = num_classes
        self.roi_size = roi_size
        self.up = roi_size * reg_feat_up_ratio
        if -(-self.up // 2) != side_num:
            raise ValueError(f'roi_size x reg_feat_up_ratio ({self.up}) '
                             f'does not give {side_num} buckets a side')
        flat = in_channels * roi_size * roi_size
        self.cls_fcs = nn.ModuleList()
        for _ in range(num_cls_fcs):
            self.cls_fcs.append(nn.Linear(flat, cls_out_channels))
            flat = cls_out_channels
        self.fc_cls = nn.Linear(flat, num_classes + 1)
        c = in_channels
        self.reg_pre_convs = nn.ModuleList()
        for _ in range(reg_pre_num):
            self.reg_pre_convs.append(ConvModule(c, reg_in_channels))
            c = reg_in_channels
        self.reg_conv_att_x = nn.Conv2d(c, 1, 1)
        self.reg_conv_att_y = nn.Conv2d(c, 1, 1)
        self.reg_post_conv_xs = nn.ModuleList()
        self.reg_post_conv_ys = nn.ModuleList()
        for _ in range(reg_post_num):
            self.reg_post_conv_xs.append(_PostConv(c, reg_in_channels, (1, 3)))
            self.reg_post_conv_ys.append(_PostConv(c, reg_in_channels, (3, 1)))
            c = reg_in_channels
        self.upsample_x = self.upsample_y = None
        if reg_feat_up_ratio > 1:
            self.upsample_x = nn.ConvTranspose1d(
                c, reg_in_channels, reg_feat_up_ratio,
                stride=reg_feat_up_ratio)
            self.upsample_y = nn.ConvTranspose1d(
                c, reg_in_channels, reg_feat_up_ratio,
                stride=reg_feat_up_ratio)
            c = reg_in_channels

        def fcs(out):
            mods, width = nn.ModuleList(), c
            for _ in range(num_reg_fcs):
                mods.append(nn.Linear(width, out))
                width = out
            return mods, width
        self.reg_offset_fcs, off_c = fcs(reg_offset_out_channels)
        self.reg_cls_fcs, cls_c = fcs(reg_cls_out_channels)
        self.fc_reg_offset = nn.Linear(off_c, 1)
        self.fc_reg_cls = nn.Linear(cls_c, 1)

    def init_weights(self, generator: torch.Generator):
        """The JAX net's initializers: lecun-normal convs, upsamplings and
        FCs, normal(0.01) `fc_cls`, `reg_conv_att_*` and `fc_reg_cls`,
        normal(0.001) `fc_reg_offset`, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.ConvTranspose1d):
                    # flax's fan-in of a (k, in, out) kernel
                    lecun_normal_(m.weight, generator,
                                  fan_in=m.weight.shape[0] *
                                  m.weight.shape[2])
                    nn.init.zeros_(m.bias)
                elif isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
            for m in (self.fc_cls, self.reg_conv_att_x, self.reg_conv_att_y,
                      self.fc_reg_cls):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
            nn.init.normal_(self.fc_reg_offset.weight, 0.0, 0.001,
                            generator=generator)

    def _side_split(self, feat):
        """(R, up) -> (R, 2 * side_num): the left half, the right reversed."""
        l_end, r_start = -(-self.up // 2), self.up // 2
        return torch.cat([feat[:, :l_end], feat[:, r_start:].flip(-1)], -1)

    def _reg_pred(self, f):
        """(R, C, up) -> offsets, logits (R, up)."""
        f = f.transpose(1, 2)
        xo, xc = f, f
        for fc in self.reg_offset_fcs:
            xo = torch.relu(fc(xo))
        for fc in self.reg_cls_fcs:
            xc = torch.relu(fc(xc))
        return self.fc_reg_offset(xo)[..., 0], self.fc_reg_cls(xc)[..., 0]

    def forward(self, x: torch.Tensor):
        """x (R, C, S, S) -> cls (R, num_classes + 1), (bucket logits,
        bucket offsets) (R, 4 * side_num), float32."""
        c = x.flatten(1)
        for fc in self.cls_fcs:
            c = torch.relu(fc(c))
        cls = self.fc_cls(c)
        g = x
        for conv in self.reg_pre_convs:
            g = conv(g)
        att_x = torch.sigmoid(self.reg_conv_att_x(g))
        att_y = torch.sigmoid(self.reg_conv_att_y(g))
        att_x = att_x / att_x.sum(dim=2, keepdim=True)
        att_y = att_y / att_y.sum(dim=3, keepdim=True)
        fx = (g * att_x).sum(dim=2)                        # (R, C, W)
        fy = (g * att_y).sum(dim=3)                        # (R, C, H)
        for conv_x, conv_y in zip(self.reg_post_conv_xs,
                                  self.reg_post_conv_ys):
            fx = conv_x(fx[:, :, None, :])[:, :, 0]
            fy = conv_y(fy[..., None])[..., 0]
        if self.upsample_x is not None:
            fx = torch.relu(self.upsample_x(fx))
            fy = torch.relu(self.upsample_y(fy))
        off_x, cls_x = self._reg_pred(fx)
        off_y, cls_y = self._reg_pred(fy)
        bucket_off = torch.cat([self._side_split(off_x),
                                self._side_split(off_y)], -1)
        bucket_cls = torch.cat([self._side_split(cls_x),
                                self._side_split(cls_y)], -1)
        return cls.float(), (bucket_cls.float(), bucket_off.float())


def _default_coder(index: int) -> dict:
    return dict(type='BucketingBBoxCoder', num_buckets=14,
                scale_factor=CASCADE_SCALE_FACTORS[min(index, 2)])


class _SABLParts:
    """What both SABL RoI heads share: the bbox head's builder, the
    sampling with gt targets and the bucket losses."""

    # the widths' keys: the JAX SABLRoIHead falls back to mmdet's
    # ConvFC names (`fc_out_channels`, `conv_out_channels`), its cascade
    # does not
    _width_fallbacks = True

    def _sabl_bbox_head(self, bh: dict, coder_cfg: dict) -> SABLBBoxHead:
        if bh.get('norm_cfg') is not None or bh.get('conv_cfg') is not None:
            _not_ported('a SABLHead conv_cfg / norm_cfg')
        fc, conv = ((bh.get('fc_out_channels', 1024),
                     bh.get('conv_out_channels', 256))
                    if self._width_fallbacks else (1024, 256))
        return SABLBBoxHead(
            self.num_classes, build_coder(coder_cfg).side_num,
            in_channels=bh.get('in_channels', bh.get('cls_in_channels', 256)),
            roi_size=self.roi_size,
            cls_out_channels=bh.get('cls_out_channels', fc),
            reg_in_channels=bh.get('reg_in_channels', conv),
            reg_feat_up_ratio=bh.get('reg_feat_up_ratio', 2),
            reg_pre_num=bh.get('reg_pre_num', 2),
            reg_post_num=bh.get('reg_post_num', 1),
            num_cls_fcs=bh.get('num_cls_fcs', 1),
            num_reg_fcs=bh.get('num_reg_fcs', 0),
            reg_offset_out_channels=bh.get('reg_offset_out_channels', 256),
            reg_cls_out_channels=bh.get('reg_cls_out_channels', 256))

    def _sabl_losses_init(self, bh: dict):
        self.loss_bbox_cls = LOSSES.build(bh.get('loss_bbox_cls') or dict(
            type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0))
        self.loss_bbox_reg = LOSSES.build(bh.get('loss_bbox_reg') or dict(
            type='SmoothL1Loss', beta=0.1, loss_weight=1.0))

    def sample_gt_rois(self, boxes, valid, batch, generator,
                       assigner=None) -> Dict:
        """`sample_rois` with each roi's matched gt box as its target."""
        return self.sample_rois(boxes, valid, batch['gt_bboxes'],
                                batch['gt_labels'].long(), batch['gt_valid'],
                                generator, assigner=assigner,
                                coder=_GT_TARGETS)

    def sabl_losses(self, cls, bucket_cls, bucket_off, s: Dict, coder
                    ) -> Dict[str, torch.Tensor]:
        """CE over the valid rois, the bucket BCE and the offsets' SmoothL1
        over the positives, of the sampled rois `s`."""
        validf = s['roi_valid'].reshape(-1).to(torch.float32)
        posf = s['roi_pos'].reshape(-1).to(torch.float32)
        avg = global_sum(validf.sum()).clamp(min=1.0)
        loss_cls = self.loss_cls(cls, s['labels'].reshape(-1), weight=validf,
                                 avg_factor=avg)
        offs, off_w, labels_1h, cls_w = coder.encode(
            s['rois'].reshape(-1, 4), s['targets'].reshape(-1, 4))
        n_pos = global_sum(posf.sum()).clamp(min=1.0)
        return dict(
            loss_cls=loss_cls,
            loss_bbox_cls=self.loss_bbox_cls(
                bucket_cls, labels_1h, weight=cls_w * posf[:, None],
                avg_factor=n_pos * 4.0 * coder.side_num),
            loss_bbox_reg=self.loss_bbox_reg(
                bucket_off, offs, weight=off_w * posf[:, None],
                avg_factor=n_pos * 4.0 * coder.offset_topk))


@HEADS.register_module()
class SABLRoIHead(_SABLParts, StandardRoIHead):

    def __init__(self, bbox_roi_extractor=None, bbox_head=None, **kwargs):
        bbox_head = dict(bbox_head or {})
        super().__init__(bbox_roi_extractor=bbox_roi_extractor,
                         bbox_head=bbox_head, **kwargs)
        if self.hard_mining:
            raise NotImplementedError(
                'OHEM/ScoreHLR hard mining is not wired into SABLRoIHead, as '
                'in the JAX package: use RandomSampler')
        self.coder = build_coder(bbox_head.get('bbox_coder') or
                                 _default_coder(0))
        self._sabl_losses_init(bbox_head)

    def _build_bbox_head(self, bbox_head: dict) -> SABLBBoxHead:
        return self._sabl_bbox_head(bbox_head, bbox_head.get('bbox_coder') or
                                    _default_coder(0))

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        s = self.sample_gt_rois(proposals, prop_valid, batch, generator)
        cls, (bucket_cls, bucket_off) = self.bbox_head(
            self._extract(feats, s['rois'], s['roi_valid']))
        losses = self.sabl_losses(cls, bucket_cls, bucket_off, s, self.coder)
        if self.mask_head is not None and 'gt_masks' in batch:
            losses['loss_mask'] = self.mask_loss(feats, s, batch['gt_masks'])
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_hw,
                    scale_factor=None, rescale=False, cfg=None,
                    keep_fn=nms_keep):
        cfg = cfg or self.test_cfg
        b, r = proposals.shape[:2]
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32,
                                 device=proposals.device)
        cls, (bucket_cls, bucket_off) = self.bbox_head(
            self._extract(feats, proposals, prop_valid))
        boxes, conf = self.coder.decode(
            proposals, (bucket_cls.reshape(b, r, -1),
                        bucket_off.reshape(b, r, -1)), max_shape=img_hw)
        scores = F.softmax(cls, dim=-1)[:, :self.num_classes].reshape(
            b, r, -1) * (conf * prop_valid)[..., None]
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, :]
        nms_cfg = dict(cfg.get('nms', {}))
        dets, labels, valid = multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            nms_cfg.get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), nms_cfg=nms_cfg,
            keep_fn=keep_fn)
        if not self.with_test_masks:
            return dets, labels, valid
        return dets, labels, valid, self.simple_test_mask(
            feats, dets, labels, valid, scale_factor if rescale else None)


@HEADS.register_module()
class CascadeSABLRoIHead(_SABLParts, CascadeRoIHead):

    _width_fallbacks = False

    def __init__(self, num_stages=3, bbox_head=None, mask_head=None,
                 **kwargs):
        if mask_head is not None:
            _not_ported('a SABL cascade with a mask head (no config sets '
                        'one)')
        bbox_heads = bbox_head if isinstance(bbox_head, list) \
            else [bbox_head] * num_stages
        super().__init__(num_stages=num_stages, bbox_head=bbox_head,
                         **kwargs)
        self.coders = [build_coder((bh or {}).get('bbox_coder') or
                                   _default_coder(i))
                       for i, bh in enumerate(bbox_heads)]
        self._sabl_losses_init(dict(bbox_heads[0] or {}))

    def _build_bbox_head(self, bbox_head: dict) -> SABLBBoxHead:
        return self._build_stage_head(0, bbox_head)

    def _build_stage_head(self, i: int, bh: dict) -> SABLBBoxHead:
        return self._sabl_bbox_head(bh, bh.get('bbox_coder') or
                                    _default_coder(i))

    def forward_train(self, feats, proposals, prop_valid, batch,
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        losses = {}
        boxes, valid = proposals, prop_valid
        for i in range(self.num_stages):
            s = self.sample_gt_rois(boxes, valid, batch, generator,
                                    assigner=self.assigners[i])
            cls, (bucket_cls, bucket_off) = self.bbox_head[i](
                self._extract(feats, s['rois'], s['roi_valid']))
            w = self.stage_loss_weights[i]
            for k, v in self.sabl_losses(cls, bucket_cls, bucket_off, s,
                                         self.coders[i]).items():
                losses[f'{k}_s{i}'] = w * v
            b, n = s['rois'].shape[:2]
            with torch.no_grad():
                boxes = self.coders[i].decode(
                    s['rois'].reshape(-1, 4),
                    (bucket_cls.detach(), bucket_off.detach()))[0].reshape(
                        b, n, 4)
            valid = s['roi_valid']
        return losses

    def simple_test(self, feats, proposals, prop_valid, img_hw,
                    scale_factor=None, rescale=False, cfg=None,
                    keep_fn=nms_keep):
        cfg = cfg or self.test_cfg
        b, r = proposals.shape[:2]
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32,
                                 device=proposals.device)
        boxes, cls_sum, conf = proposals, 0.0, None
        for i, head in enumerate(self.bbox_head):
            cls, (bucket_cls, bucket_off) = head(
                self._extract(feats, boxes, prop_valid))
            cls_sum = cls_sum + F.softmax(cls, dim=-1)
            boxes, conf = self.coders[i].decode(
                boxes, (bucket_cls.reshape(b, r, -1),
                        bucket_off.reshape(b, r, -1)), max_shape=img_hw)
        scores = (cls_sum / self.num_stages)[:, :self.num_classes].reshape(
            b, r, -1) * (conf * prop_valid)[..., None]
        if rescale and scale_factor is not None:
            boxes = boxes / torch.as_tensor(
                scale_factor, dtype=torch.float32,
                device=boxes.device)[:, None, :]
        return multiclass_nms(
            boxes, scores, cfg.get('score_thr', 0.05),
            cfg.get('nms', {}).get('iou_threshold', 0.5),
            max_per_img=cfg.get('max_per_img', 100), keep_fn=keep_fn)
