"""Single-stage detector: backbone -> neck -> dense head (port of
`ld_tpu/models/detectors/single_stage.py`).

One `nn.Module` owns the backbone, neck and head under mmdet's names
(`backbone.*`, `neck.*`, `bbox_head.*`). `forward` returns the head's
per-level NCHW outputs (and the FPN features with `output_features=True`);
`forward_train` returns the dict of scalar losses of a padded batch;
`forward_test` returns padded fixed-size detections.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ld_tpu_torch.models.necks.seq import build_neck
from ld_tpu_torch.utils.registry import BACKBONES, DETECTORS, HEADS


@DETECTORS.register_module()
class SingleStageDetector(nn.Module):

    def __init__(self, backbone, neck=None, bbox_head=None, train_cfg=None,
                 test_cfg=None, pretrained=None):
        super().__init__()
        self.backbone = BACKBONES.build(dict(backbone))
        self.neck = build_neck(neck)
        head_cfg = dict(bbox_head)
        head_cfg.setdefault('train_cfg', train_cfg)
        head_cfg.setdefault('test_cfg', test_cfg)
        self.bbox_head = HEADS.build(head_cfg)
        # the name of published ImageNet weights; nothing is downloaded
        self.pretrained = pretrained
        self.num_classes = self.bbox_head.num_classes

    def init_weights(self, generator: torch.Generator):
        for m in (self.backbone, self.neck, self.bbox_head):
            if m is not None:
                m.init_weights(generator)

    def forward(self, images: torch.Tensor, output_features: bool = False):
        """images (B, 3, H, W) -> (cls_scores, bbox_preds), NCHW per level;
        with output_features, ((cls_scores, bbox_preds), neck features)."""
        x = self.backbone(images)
        if self.neck is not None:
            x = self.neck(x)
        outs = self.bbox_head(list(x))
        if output_features:
            return outs, x
        return outs

    def forward_train(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """batch: image (B, 3, H, W), gt_bboxes (B, G, 4), gt_labels (B, G),
        gt_valid (B, G) bool, img_hw (B, 2) -> the head's loss dict."""
        outs = self(batch['image'])
        featmap_sizes = [tuple(c.shape[-2:]) for c in outs[0]]
        return self.bbox_head.loss(outs, batch, featmap_sizes)

    def forward_test(self, batch: Dict[str, torch.Tensor], rescale=False):
        """batch: image (B, 3, H, W), img_hw (B, 2), optional scale_factor
        (B, 4) -> (dets (B, 100, 5), labels, valid)."""
        outs = self(batch['image'])
        return self.bbox_head.get_bboxes(
            outs, batch['img_hw'], batch.get('scale_factor'), rescale=rescale)


# named wrappers so the configs' `type=` names of the single-stage detectors
# resolve
for _name in ('GFL', 'ATSS', 'FCOS', 'RetinaNet', 'VFNet',
              'RepPointsDetector', 'SSD', 'FoveaBox', 'PAA', 'FSAF',
              'NASFCOS', 'TOOD', 'YOLOV3'):
    DETECTORS.register_module(name=_name, module=type(
        _name, (SingleStageDetector, ), {}))
