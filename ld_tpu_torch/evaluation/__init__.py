from .coco_eval import CocoEvaluator
from .mean_ap import average_precision, eval_map, eval_recalls, tpfp_default

__all__ = ['CocoEvaluator', 'average_precision', 'eval_map', 'eval_recalls',
           'tpfp_default']
