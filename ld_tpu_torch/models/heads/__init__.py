from .gfl_head import GFLHead

__all__ = ['GFLHead']
