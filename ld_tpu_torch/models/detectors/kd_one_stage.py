"""Teacher-student distillation detector (single stage); port of
`ld_tpu/models/detectors/kd_one_stage.py:29-92`.

A student single-stage detector plus a frozen teacher built from
`teacher_config`. The teacher is held outside the module tree (as the
reference holds it), so it is in neither `parameters()` nor the student's
`state_dict()`; `.to()` / `.cuda()` still move it, and it stays in eval
mode whatever `train()` is called with. It runs under `torch.no_grad()`, and
its outputs and FPN features reach the LD head detached, so no teacher
graph is ever built.

The teacher computes in float32 when `teacher_config` is a path (its file's
model, built with no compute dtype, as in `ld_tpu/models/detectors/
kd_one_stage.py:54-59`) and in the student's compute dtype when it is a dict
with a `model`, which `apply_model_dtype` lowers with the student.
"""
from __future__ import annotations

import os
from typing import Dict

import torch

from ld_tpu_torch.utils.config import Config
from ld_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn, fuse_conv_bn_cfg_ok
from ld_tpu_torch.utils.registry import DETECTORS
from .single_stage import SingleStageDetector

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def _resolve_config(path: str) -> str:
    """A teacher config path as given, else relative to the repo root."""
    if os.path.exists(path):
        return path
    cand = os.path.join(_REPO_ROOT, path)
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(f'teacher config {path} not found')


class FrozenTeacher:
    """The frozen-teacher part of a distillation detector (an `nn.Module`
    mixin): `_build_teacher` makes the teacher from `teacher_config` (a
    config path, or a dict with a `model`) and hides it; it moves with the
    student and stays in eval mode."""

    def _build_teacher(self, teacher_config, teacher_ckpt, eval_teacher,
                       output_feature):
        # the teacher always runs in eval: with eval_teacher=False the
        # reference lets its BNs follow train mode, a no-op under norm_eval
        self.eval_teacher = eval_teacher
        self.output_feature = output_feature
        if isinstance(teacher_config, str):
            teacher_config = Config.fromfile(_resolve_config(teacher_config))
        self.teacher_model_cfg = dict(teacher_config['model'])
        teacher = DETECTORS.build(self.teacher_model_cfg)
        teacher.requires_grad_(False)
        # a list hides the teacher from nn.Module's registration
        self._teacher = [teacher.eval()]
        # the published teacher weights' path; loaded by the caller
        self.teacher_ckpt = teacher_ckpt

    @property
    def teacher(self):
        return self._teacher[0]

    def init_teacher_weights(self, generator: torch.Generator):
        """Random teacher weights (the JAX package's initializers), for runs
        without the published teacher checkpoint."""
        self.teacher.init_weights(generator)

    def fold_teacher_bn(self) -> bool:
        """Fold the teacher's BNs into its convs (value-identical: it runs in
        eval only); refused for a ConvWS teacher. Returns whether it
        folded."""
        if not fuse_conv_bn_cfg_ok(self.teacher_model_cfg):
            return False
        fuse_conv_bn(self.teacher)
        return True

    def _apply(self, fn, recurse=True):
        # .to() / .cuda() / .float() reach the hidden teacher too
        self.teacher._apply(fn, recurse)
        return super()._apply(fn, recurse)

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher.eval()
        return self


@DETECTORS.register_module()
class KnowledgeDistillationSingleStageDetector(FrozenTeacher,
                                               SingleStageDetector):

    def __init__(self, backbone, neck, bbox_head, teacher_config,
                 teacher_ckpt=None, eval_teacher=True, output_feature=False,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__(backbone, neck, bbox_head, train_cfg, test_cfg,
                         pretrained)
        self._build_teacher(teacher_config, teacher_ckpt, eval_teacher,
                            output_feature)

    def forward_train(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        outs, feats = self(batch['image'], output_features=True)
        with torch.no_grad():
            t_outs, t_feats = self.teacher(batch['image'],
                                           output_features=True)
        t_outs = tuple([x.detach() for x in part] for part in t_outs)
        t_feats = [x.detach() for x in t_feats]
        featmap_sizes = [tuple(c.shape[-2:]) for c in outs[0]]
        return self.bbox_head.loss(
            outs, batch, featmap_sizes, t_outs,
            student_feats=feats if self.output_feature else None,
            teacher_feats=t_feats if self.output_feature else None)


@DETECTORS.register_module()
class IMDetector(KnowledgeDistillationSingleStageDetector):
    """The pure feature-imitation detector of the reference
    (mmdet/models/detectors/imitation.py); the same wiring."""
