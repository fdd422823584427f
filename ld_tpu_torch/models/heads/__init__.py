from .atss_gfl_head import ATSSGFLHead, LDATSSHead
from .fcos_gfl_head import FCOSGFLHead, LDFCOSCompareHead, LDFCOSHead
from .gfl_head import GFLHead
from .gfocal_head import GFocalHead
from .ld_gflv2 import IMv2Head, LDv2Head
from .ld_head import IMHead, LDHead
from .retina_gfl_head import LDRetinaHead, RetinaGFLHead

__all__ = ['GFLHead', 'IMHead', 'LDHead', 'GFocalHead', 'LDv2Head',
           'IMv2Head', 'ATSSGFLHead', 'LDATSSHead', 'FCOSGFLHead',
           'LDFCOSHead', 'LDFCOSCompareHead', 'RetinaGFLHead',
           'LDRetinaHead']
