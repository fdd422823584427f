from . import losses  # noqa: F401 — registers loss types
from . import backbones  # noqa: F401 — registers backbone types
from . import necks  # noqa: F401
from . import heads  # noqa: F401
from . import detectors  # noqa: F401

import inspect

from ld_tpu_torch.models.layers import as_torch_dtype
from ld_tpu_torch.utils.registry import BACKBONES, DETECTORS, HEADS, NECKS

# model-cfg keys that name sub-modules whose compute dtype can be lowered,
# and the registry their 'type' lives in
_DTYPE_SLOTS = (('backbone', BACKBONES), ('neck', NECKS),
                ('bbox_head', HEADS), ('rpn_head', HEADS))


def _accepts_dtype(cls) -> bool:
    for c in inspect.getmro(cls):
        init = c.__dict__.get('__init__')
        if init is not None and \
                'dtype' in inspect.signature(init).parameters:
            return True
    return False


def apply_model_dtype(model_cfg: dict, dtype) -> dict:
    """Inject a compute dtype into every sub-module config that takes one
    (port of `ld_tpu/models/__init__.py:31-57`).

    The top-level `dtype` key of the configs (`configs/_base_/
    default_runtime.py` sets 'bfloat16'): the backbone, neck and head
    towers compute in it while parameters, predictions, losses and the
    optimizer stay float32. A sub-module whose class takes no `dtype` is
    left untouched, and an explicit per-module `dtype` in the config wins.
    A teacher given as a dict with a `model` is lowered the same way; a
    teacher named by its config path is not, and computes in float32.
    Returns a new dict.
    """
    dtype = as_torch_dtype(dtype)
    out = dict(model_cfg)
    for key, registry in _DTYPE_SLOTS:
        sub = out.get(key)
        if not isinstance(sub, dict) or 'dtype' in sub:
            continue
        cls = registry.get(sub.get('type')) if isinstance(
            sub.get('type'), str) else sub.get('type')
        if cls is not None and _accepts_dtype(cls):
            out[key] = dict(sub, dtype=dtype)
    tc = out.get('teacher_config')
    if isinstance(tc, dict) and isinstance(tc.get('model'), dict):
        out['teacher_config'] = dict(tc,
                                     model=apply_model_dtype(tc['model'],
                                                             dtype))
    return out


def build_detector(cfg, train_cfg=None, test_cfg=None, dtype=None):
    """Config-driven detector construction (port of
    `ld_tpu/models/__init__.py:60-74`). `dtype` (a config's top-level
    `dtype`, threaded here by `init_detector` and `train_detector`) lowers
    the towers that take one, through `apply_model_dtype`; None or
    'float32' builds the float32 detector."""
    cfg = dict(cfg)
    if train_cfg is not None:
        cfg.setdefault('train_cfg', train_cfg)
    if test_cfg is not None:
        cfg.setdefault('test_cfg', test_cfg)
    if dtype is not None:
        cfg = apply_model_dtype(cfg, dtype)
    return DETECTORS.build(cfg)


__all__ = ['apply_model_dtype', 'build_detector']
