from .aug_test import aug_test, build_aug_views
from .inference import (async_inference_detector, imshow_gt_det_bboxes,
                        inference_detector, init_detector, show_result)
from .test import eval_detector
from .train import set_random_seed, train_detector

__all__ = ['async_inference_detector', 'aug_test', 'build_aug_views',
           'eval_detector', 'imshow_gt_det_bboxes', 'inference_detector',
           'init_detector', 'set_random_seed', 'show_result',
           'train_detector']
