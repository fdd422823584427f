from .anchors import AnchorGenerator
from .atss_assigner import AssignResult, ATSSAssigner
from .boxes import anchor_center, bbox2distance, bbox_overlaps, distance2bbox
from .integral import integral
from .max_iou_assigner import MaxIoUAssigner
from .nms_cuda import nms_keep, nms_keep_ref

__all__ = [
    'AnchorGenerator', 'AssignResult', 'ATSSAssigner', 'anchor_center',
    'bbox2distance', 'bbox_overlaps', 'distance2bbox', 'integral',
    'MaxIoUAssigner', 'nms_keep', 'nms_keep_ref'
]
