from .gfl_head import GFLHead
from .ld_head import LDHead

__all__ = ['GFLHead', 'LDHead']
