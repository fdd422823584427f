"""Two-stage detectors (Faster R-CNN family) and the LD through the RPN;
port of `ld_tpu/models/detectors/two_stage.py`.

`TwoStageDetector`, registered as `FasterRCNN`, `MaskRCNN`, `CascadeRCNN`,
`HybridTaskCascade`, `MaskScoringRCNN`, `GridRCNN`, `PointRend`, `SCNet`,
`DoubleHeadRCNN` and `DynamicRCNN` too (each the same detector with
another RoI head; Mask R-CNN's and PointRend's have a `mask_head`):
backbone
-> neck -> `rpn_head` -> proposals -> `roi_head`, one `nn.Module` under
mmdet's names. `forward_train` returns the RPN's and the RoI head's
losses: the RPN loss, its proposals (under `no_grad`, from
`train_cfg.rpn_proposal`, else the RPN test config, as in the JAX
package), the RoI head's sampled losses. Both samplers draw from the
`generator` passed in (`make_train_step` passes one seeded from the run's
seed and the rank). `forward_test` returns padded (dets, labels, valid),
as a single-stage detector does, and with a mask head a 4th output, the
detections' (B, 100, 28, 28) masks.

  * `FastRCNN`: the RoI head on `batch['proposals']` (B, P, 4) (and
    `proposals_valid`), else on its own RPN, as the JAX class;
  * `RPN`: the RPN alone; it tests to its proposals as class-agnostic
    detections scored by rank (1, 1 - 1/P, ...);
  * `KnowledgeDistillationTwoStageDetector`: a frozen teacher (held as the
    single-stage one: outside `parameters()` / `state_dict()`, in eval, under
    `no_grad`) whose RPN outputs feed the student RPN's `loss_with_teacher`
    (`loss_rpn_kd`, `loss_rpn_ld`); the RoI head trains as usual.

`CascadeRCNN` and `HybridTaskCascade` are the same detector with a
`CascadeRoIHead` / `HybridTaskCascadeRoIHead`; as in the JAX package
(`ld_tpu/models/detectors/two_stage.py:59-68`), a `StandardRoIHead` whose
`bbox_head` is a `SABLHead` is routed to `SABLRoIHead`, and a
`CascadeRoIHead` whose stages are `SABLHead`s to `CascadeSABLRoIHead`.

  * `TridentFasterRCNN` (`ld_tpu/models/detectors/two_stage.py:319-354`):
    the `TridentResNet` folds its branches into the batch (B -> 3B), so in
    training the gts and image sizes are tiled a branch, and the RPN and the
    RoI head see 3B images; at test every feature map and RPN output is
    sliced to the `test_branch_idx` third (ROADMAP.md caveat 91).
  * A `CascadeRPNHead` (`rpn_head`) runs through the same calls: its
    forward builds its anchors, its `loss` and `get_proposals` are the JAX
    `cascade_rpn_loss` / `cascade_rpn_proposals` (caveat 93).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ld_tpu_torch.models.necks.seq import build_neck
from ld_tpu_torch.utils.registry import BACKBONES, DETECTORS, HEADS
from .kd_one_stage import FrozenTeacher


def reject_mask_head(model, what: str) -> None:
    """Raise for a detector whose `forward_test` returns masks where `what`
    takes its three outputs (dets, labels, valid) only: the JAX counterpart
    cannot run such a model either (ROADMAP.md caveat 21). HTC's RoI head
    tests without masks, as the JAX one, and passes."""
    roi_head = getattr(model, 'roi_head', None)
    if getattr(roi_head, 'with_test_masks', False):
        raise NotImplementedError(
            f'{what} does not take the masks of a detector with a mask head '
            '(Mask R-CNN), as in the JAX package (ROADMAP.md caveat 21): '
            'use eval_detector or forward_test')


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


@DETECTORS.register_module()
class TwoStageDetector(nn.Module):

    def __init__(self, backbone, neck=None, rpn_head=None, roi_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        train_cfg = dict(train_cfg or {})
        test_cfg = dict(test_cfg or {})
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = build_neck(neck)
        rpn_cfg = dict(rpn_head or dict(type='RPNHead', in_channels=256))
        rpn_cfg.setdefault('train_cfg', train_cfg.get('rpn'))
        rpn_cfg.setdefault('test_cfg', test_cfg.get('rpn'))
        self.rpn_head = HEADS.build(rpn_cfg)
        if roi_head is not None or not isinstance(self, RPN):
            roi_cfg = dict(roi_head or dict(type='StandardRoIHead'))
            # a SABLHead bbox head routes the RoI head to its SABL form
            bh = roi_cfg.get('bbox_head')
            if roi_cfg.get('type') == 'CascadeRoIHead' and \
                    isinstance(bh, list) and \
                    any((h or {}).get('type') == 'SABLHead' for h in bh):
                roi_cfg['type'] = 'CascadeSABLRoIHead'
            elif roi_cfg.get('type', 'StandardRoIHead') == \
                    'StandardRoIHead' and isinstance(bh, dict) and \
                    bh.get('type') == 'SABLHead':
                roi_cfg['type'] = 'SABLRoIHead'
            roi_cfg.setdefault('train_cfg', train_cfg.get('rcnn'))
            roi_cfg.setdefault('test_cfg', test_cfg.get('rcnn'))
            self.roi_head = HEADS.build(roi_cfg)
            self.num_classes = self.roi_head.num_classes
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        # the name of published ImageNet weights; nothing is downloaded
        self.pretrained = pretrained

    def init_weights(self, generator: torch.Generator):
        for m in (self.backbone, self.neck, self.rpn_head,
                  getattr(self, 'roi_head', None)):
            if m is not None:
                m.init_weights(generator)

    def extract_feat(self, images: torch.Tensor):
        x = self.backbone(images)
        return list(self.neck(x)) if self.neck is not None else list(x)

    def forward(self, images: torch.Tensor):
        """images (B, 3, H, W) -> (neck features, RPN outputs)."""
        feats = self.extract_feat(images)
        return feats, self.rpn_head(feats)

    def _proposals(self, rpn_outs, img_hw, cfg=None):
        with torch.no_grad():
            return self.rpn_head.get_proposals(
                tuple([x.detach() for x in part] for part in rpn_outs),
                img_hw, cfg=cfg)

    def _rpn_losses(self, rpn_outs, batch, generator):
        sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
        return dict(self.rpn_head.loss(rpn_outs, batch, sizes, generator))

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator = None
                      ) -> Dict[str, torch.Tensor]:
        """batch: image, gt_bboxes, gt_labels, gt_valid, img_hw -> the RPN's
        and the RoI head's losses."""
        generator = generator or _default_generator(batch['image'].device)
        feats, rpn_outs = self(batch['image'])
        losses = self._rpn_losses(rpn_outs, batch, generator)
        proposals, valid = self._proposals(
            rpn_outs, batch['img_hw'], self.train_cfg.get('rpn_proposal'))
        losses.update(self.roi_head.forward_train(feats, proposals, valid,
                                                  batch, generator))
        return losses

    def forward_test(self, batch: Dict[str, torch.Tensor], rescale=False):
        """batch: image, img_hw, optional scale_factor -> (dets (B, 100, 5),
        labels, valid) and, with a mask head, masks (B, 100, 28, 28)."""
        feats, rpn_outs = self(batch['image'])
        proposals, valid = self._proposals(rpn_outs, batch['img_hw'])
        return self.roi_head.simple_test(
            feats, proposals, valid, batch['img_hw'],
            batch.get('scale_factor'), rescale=rescale)


for _name in ('FasterRCNN', 'MaskRCNN', 'CascadeRCNN',
              'HybridTaskCascade', 'MaskScoringRCNN', 'GridRCNN',
              'PointRend', 'SCNet', 'DoubleHeadRCNN', 'DynamicRCNN'):
    DETECTORS.register_module(name=_name, module=type(
        _name, (TwoStageDetector, ), {}))


@DETECTORS.register_module()
class FastRCNN(TwoStageDetector):

    def _given(self, batch):
        props = batch['proposals']
        return props, batch.get('proposals_valid', torch.ones(
            props.shape[:2], dtype=torch.bool, device=props.device))

    def forward_train(self, batch, generator=None):
        if 'proposals' not in batch:
            return super().forward_train(batch, generator)
        generator = generator or _default_generator(batch['image'].device)
        feats = self.extract_feat(batch['image'])
        return dict(self.roi_head.forward_train(
            feats, *self._given(batch), batch, generator))

    def forward_test(self, batch, rescale=False):
        if 'proposals' not in batch:
            return super().forward_test(batch, rescale)
        return self.roi_head.simple_test(
            self.extract_feat(batch['image']), *self._given(batch),
            batch['img_hw'], batch.get('scale_factor'), rescale=rescale)


@DETECTORS.register_module()
class RPN(TwoStageDetector):

    def __init__(self, backbone, neck=None, rpn_head=None, train_cfg=None,
                 test_cfg=None, pretrained=None):
        # the rpn configs put the RPN's cfgs at the top level
        train_cfg = dict(train_cfg or {})
        test_cfg = dict(test_cfg or {})
        if train_cfg and 'rpn' not in train_cfg:
            train_cfg = dict(rpn=train_cfg)
        if test_cfg and 'rpn' not in test_cfg:
            test_cfg = dict(rpn=test_cfg)
        super().__init__(backbone, neck, rpn_head, None, train_cfg, test_cfg,
                         pretrained)
        self.num_classes = 1

    def forward_train(self, batch, generator=None):
        generator = generator or _default_generator(batch['image'].device)
        return self._rpn_losses(self(batch['image'])[1], batch, generator)

    def forward_test(self, batch, rescale=False):
        _, rpn_outs = self(batch['image'])
        proposals, valid = self._proposals(rpn_outs, batch['img_hw'],
                                           self.test_cfg.get('rpn'))
        b, p = proposals.shape[:2]
        scores = 1.0 - torch.arange(p, device=proposals.device,
                                    dtype=torch.float32) / p
        if rescale and batch.get('scale_factor') is not None:
            proposals = proposals / torch.as_tensor(
                batch['scale_factor'], dtype=torch.float32,
                device=proposals.device)[:, None, :]
        dets = torch.cat([proposals, scores.expand(b, p)[..., None]], -1)
        return dets, torch.zeros((b, p), dtype=torch.long,
                                 device=dets.device), valid


@DETECTORS.register_module()
class KnowledgeDistillationTwoStageDetector(FrozenTeacher, TwoStageDetector):

    def __init__(self, backbone, neck, rpn_head, roi_head, teacher_config,
                 teacher_ckpt=None, eval_teacher=True, output_feature=False,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__(backbone, neck, rpn_head, roi_head, train_cfg,
                         test_cfg, pretrained)
        self._build_teacher(teacher_config, teacher_ckpt, eval_teacher,
                            output_feature)

    def _rpn_losses(self, rpn_outs, batch, generator):
        with torch.no_grad():
            _, t_rpn_outs = self.teacher(batch['image'])
        t_rpn_outs = tuple([x.detach() for x in part] for part in t_rpn_outs)
        sizes = [tuple(c.shape[-2:]) for c in rpn_outs[0]]
        return dict(self.rpn_head.loss_with_teacher(
            rpn_outs, batch, sizes, t_rpn_outs, generator))


@DETECTORS.register_module()
class TridentFasterRCNN(TwoStageDetector):

    def tile_batch(self, batch):
        """`batch` with its gts and image sizes tiled a branch,
        branch-major as the backbone tiles the images."""
        nb = self.backbone.num_branch
        tiled = dict(batch)
        for k in ('gt_bboxes', 'gt_labels', 'gt_valid', 'img_hw',
                  'gt_masks'):
            if k in tiled:
                v = torch.as_tensor(tiled[k])
                tiled[k] = v.repeat(nb, *(1, ) * (v.dim() - 1))
        return tiled

    def test_branch(self, feats, rpn_outs, b: int):
        """The `test_branch_idx` third of the features and RPN outputs of
        `b` images."""
        idx = self.backbone.test_branch_idx
        sl = slice(idx * b, (idx + 1) * b)
        return [f[sl] for f in feats], tuple([x[sl] for x in part]
                                             for part in rpn_outs)

    def forward_train(self, batch, generator=None):
        return super().forward_train(self.tile_batch(batch), generator)

    def forward_test(self, batch, rescale=False):
        """The `test_branch_idx` branch's detections."""
        feats, rpn_outs = self.test_branch(*self(batch['image']),
                                           batch['image'].shape[0])
        proposals, valid = self._proposals(rpn_outs, batch['img_hw'])
        return self.roi_head.simple_test(
            feats, proposals, valid, batch['img_hw'],
            batch.get('scale_factor'), rescale=rescale)
