from .inference import inference_detector, init_detector
from .test import eval_detector
from .train import set_random_seed, train_detector

__all__ = ['eval_detector', 'inference_detector', 'init_detector',
           'set_random_seed', 'train_detector']
