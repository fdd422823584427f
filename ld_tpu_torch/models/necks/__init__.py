from ld_tpu_torch.utils.registry import NECKS

from .fpn import FPN
from .hrfpn import HRFPN

# the JAX package's other necks (configs name them)
NECKS.not_ported.update(
    {name: 'ROADMAP.md A7'
     for name in ('BFP', 'NASFPN', 'FPN_CARAFE', 'NASFCOS_FPN', 'FPG', 'RFP',
                  'PAFPN', 'ChannelMapper')})

__all__ = ['FPN', 'HRFPN']
