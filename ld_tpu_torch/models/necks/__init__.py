from ld_tpu_torch.utils.registry import NECKS

from .extra_necks import BFP, FPG, FPN_CARAFE, NASFCOS_FPN, NASFPN, RFP
from .fpn import FPN, PAFPN, ChannelMapper
from .hrfpn import HRFPN
from .seq import SequentialNeck, build_neck

__all__ = ['FPN', 'HRFPN', 'PAFPN', 'ChannelMapper', 'NASFPN', 'FPN_CARAFE',
           'NASFCOS_FPN', 'FPG', 'RFP', 'BFP', 'SequentialNeck',
           'build_neck']
