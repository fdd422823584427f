from .coco_eval import CocoEvaluator

__all__ = ['CocoEvaluator']
