from .transforms import (Compose, Normalize, Pad, Resize, collate_batch,
                         select_pad_bucket)

__all__ = ['Compose', 'Normalize', 'Pad', 'Resize', 'collate_batch',
           'select_pad_bucket']
