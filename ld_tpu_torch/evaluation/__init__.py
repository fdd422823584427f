from .coco_eval import CocoEvaluator
from .mean_ap import average_precision, eval_map, eval_recalls, tpfp_default
from .segm_eval import SegmEvaluator, encode_mask_results

__all__ = ['CocoEvaluator', 'SegmEvaluator', 'average_precision',
           'encode_mask_results', 'eval_map', 'eval_recalls', 'tpfp_default']
