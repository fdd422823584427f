from ld_tpu_torch.utils.registry import HEADS

from .gfl_head import GFLHead
from .ld_head import IMHead, LDHead

# the JAX package's other GFL-family heads
HEADS.not_ported.update(
    {name: 'ROADMAP.md item 20'
     for name in ('GFocalHead', 'LDv2Head', 'IMv2Head', 'ATSSGFLHead',
                  'LDATSSHead', 'FCOSGFLHead', 'LDFCOSHead',
                  'LDFCOSCompareHead', 'RetinaGFLHead', 'LDRetinaHead')})

__all__ = ['GFLHead', 'IMHead', 'LDHead']
