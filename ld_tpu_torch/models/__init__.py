from . import backbones  # noqa: F401 — registers backbone types
from . import necks  # noqa: F401
from . import heads  # noqa: F401
from . import detectors  # noqa: F401

from ld_tpu_torch.utils.registry import DETECTORS


def build_detector(cfg, train_cfg=None, test_cfg=None):
    """Config-driven detector construction (port of
    `ld_tpu/models/__init__.py:60-74`), in float32: a reduced compute dtype
    (the JAX package's `dtype` argument) is not ported yet."""
    cfg = dict(cfg)
    if train_cfg is not None:
        cfg.setdefault('train_cfg', train_cfg)
    if test_cfg is not None:
        cfg.setdefault('test_cfg', test_cfg)
    return DETECTORS.build(cfg)


__all__ = ['build_detector']
