from .anchors import AnchorGenerator
from .boxes import anchor_center, bbox2distance, bbox_overlaps, distance2bbox
from .integral import integral
from .nms_cuda import nms_keep, nms_keep_ref

__all__ = [
    'AnchorGenerator', 'anchor_center', 'bbox2distance', 'bbox_overlaps',
    'distance2bbox', 'integral', 'nms_keep', 'nms_keep_ref'
]
