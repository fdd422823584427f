from .anchors import AnchorGenerator
from .atss_assigner import AssignResult, ATSSAssigner
from .boxes import anchor_center, bbox2distance, bbox_overlaps, distance2bbox
from .coder import build_coder
from .extra_assigners import ApproxMaxIoUAssigner, PointAssigner
from .integral import integral
from .max_iou_assigner import MaxIoUAssigner
from .nms_cuda import nms_keep, nms_keep_ref
from .roi_align import multi_level_roi_align, roi_align
from .samplers import build_sampler

__all__ = [
    'AnchorGenerator', 'AssignResult', 'ATSSAssigner', 'anchor_center',
    'bbox2distance', 'bbox_overlaps', 'distance2bbox', 'integral',
    'MaxIoUAssigner', 'nms_keep', 'nms_keep_ref', 'build_coder',
    'roi_align', 'multi_level_roi_align', 'build_sampler',
    'ApproxMaxIoUAssigner', 'PointAssigner'
]
