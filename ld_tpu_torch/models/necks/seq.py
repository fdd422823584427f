"""Stacked necks (port of `ld_tpu/models/necks/seq.py`): mmdet's
`neck=[cfg1, cfg2]`, e.g. Libra R-CNN's FPN then BFP, as an
`nn.Sequential` of the built necks, so their names are mmdet's `neck.0.*`,
`neck.1.*`. Each neck takes the previous one's tuple of levels."""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.utils.registry import NECKS


class SequentialNeck(nn.Sequential):

    def init_weights(self, generator: torch.Generator):
        for neck in self:
            neck.init_weights(generator)

    @property
    def out_channels(self) -> int:
        """The last neck's int `out_channels` (or `in_channels`), else 256,
        as the JAX property."""
        for neck in reversed(self):
            oc = getattr(neck, 'out_channels', None) or \
                getattr(neck, 'in_channels', None)
            if isinstance(oc, int):
                return oc
        return 256


def build_neck(neck):
    """A neck of a config's `neck` entry: None, a dict, or a list of dicts
    (a `SequentialNeck`)."""
    if not neck:
        return None
    if isinstance(neck, (list, tuple)):
        return SequentialNeck(*(NECKS.build(dict(n)) for n in neck))
    return NECKS.build(dict(neck))
