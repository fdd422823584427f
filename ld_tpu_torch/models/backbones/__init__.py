from ld_tpu_torch.utils.registry import BACKBONES

from .hrnet import HRModule, HRNet
from .regnet import RegNet
from .res2net import Bottle2neck, Res2Net
from .resnet import BasicBlock, Bottleneck, ResNet, ResNetV1d, ResNeXt

# the JAX package's other backbones (configs name them)
BACKBONES.not_ported.update(
    {name: 'ROADMAP.md item 22'
     for name in ('DetectoRS_ResNet', 'TridentResNet', 'ResNeSt',
                  'HourglassNet', 'Darknet', 'SSDVGG')})

__all__ = ['ResNet', 'ResNeXt', 'ResNetV1d', 'Res2Net', 'HRNet', 'RegNet',
           'BasicBlock', 'Bottleneck', 'Bottle2neck', 'HRModule']
