"""LD on a GFocalV2 (DGQP) student: `LDv2Head` and the imitation ablation's
`IMv2Head`; port of `ld_tpu/models/heads/ld_gflv2.py:27-116` and
`imitation_heads.py:34-42`.

The LD machinery of `LDHead` (main-region LD, VLR LD, class KD, the GI
imitation region) on the GFocalHead's towers and outputs, with two twists
of the reference kept for parity; both teacher and student hand over
(probability scores, box distributions, raw cls logits):
  * the soft label is the teacher's RAW cls logits, and the class KD runs
    on raw logits on both sides, normalised by each level's positive count;
  * the GI score is the teacher's raw logits minus the student's
    probabilities, with no sigmoid on either (`gi_scores`).
`IMv2Head` is `LDv2Head` with the DFL term set to zero.
"""
from __future__ import annotations

from typing import Dict

import torch

from ld_tpu_torch.ops.nms_cuda import nms_keep
from ld_tpu_torch.utils.registry import HEADS
from .gfocal_head import GFocalHead
from .ld_head import LDHead


@HEADS.register_module()
class LDv2Head(LDHead, GFocalHead):
    """LDHead's losses over GFocalHead's forward (method order: LDHead,
    GFocalHead, GFLHead)."""

    def gi_scores(self, cls_flat, soft_label_flat):
        # the reference compares raw teacher logits with student
        # probabilities, without sigmoids
        return soft_label_flat - cls_flat

    def gi_levels(self, outputs, soft_teacher):
        """(student probabilities, teacher raw logits, student box, teacher
        box) of the (cls_scores, bbox_preds, cls_logits) outputs."""
        return outputs[0], soft_teacher[2], outputs[1], soft_teacher[1]

    def loss(self, outputs, batch, featmap_sizes, soft_teacher,
             student_feats=None, teacher_feats=None,
             keep_fn=nms_keep) -> Dict[str, torch.Tensor]:
        """The LD loss: QFL on the student's probability scores, the
        teacher's raw logits as the soft label, class KD on raw logits."""
        cls_scores, bbox_preds, cls_logits = outputs
        _, t_bbox_preds, t_cls_logits = soft_teacher
        return super().loss((cls_scores, bbox_preds), batch, featmap_sizes,
                            (t_cls_logits, t_bbox_preds), student_feats,
                            teacher_feats, keep_fn,
                            kd_logits=(cls_logits, t_cls_logits))


@HEADS.register_module()
class IMv2Head(LDv2Head):
    """The imitation ablation on GFocalV2: LDv2 with no DFL term."""

    def loss(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        losses = super().loss(*args, **kwargs)
        losses['loss_dfl'] = torch.zeros((), device=losses['loss_cls'].device)
        return losses
