from ld_tpu_torch.utils.registry import BACKBONES

from .darknet import Darknet
from .hrnet import HRModule, HRNet
from .regnet import RegNet
from .res2net import Bottle2neck, Res2Net
from .resnest import ResNeSt
from .resnet import (BasicBlock, Bottleneck, DetectoRS_ResNet, ResNet,
                     ResNetV1d, ResNeXt, SAConv2d, TridentResNet)
from .ssd_vgg import SSDVGG

# the JAX package's other backbones (configs name them)
BACKBONES.not_ported['HourglassNet'] = 'ROADMAP.md Queue A item 9'

__all__ = ['ResNet', 'ResNeXt', 'ResNetV1d', 'Res2Net', 'HRNet', 'RegNet',
           'ResNeSt', 'SSDVGG', 'BasicBlock', 'Bottleneck', 'Bottle2neck',
           'HRModule', 'DetectoRS_ResNet', 'SAConv2d', 'Darknet',
           'TridentResNet']
