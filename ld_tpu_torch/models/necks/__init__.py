from ld_tpu_torch.utils.registry import NECKS

from .extra_necks import FPG, FPN_CARAFE, NASFCOS_FPN, NASFPN, RFP
from .fpn import FPN, PAFPN, ChannelMapper
from .hrfpn import HRFPN

# the JAX package's other necks (configs name them)
NECKS.not_ported.update({'BFP': 'ROADMAP.md Queue A item 4'})

__all__ = ['FPN', 'HRFPN', 'PAFPN', 'ChannelMapper', 'NASFPN', 'FPN_CARAFE',
           'NASFCOS_FPN', 'FPG', 'RFP']
