from ld_tpu_torch.utils.registry import BACKBONES

from .resnet import BasicBlock, Bottleneck, ResNet

# the JAX package's other backbones (configs name them)
BACKBONES.not_ported.update(
    {name: 'ROADMAP.md item 22'
     for name in ('ResNeXt', 'ResNetV1d', 'DetectoRS_ResNet',
                  'TridentResNet', 'Res2Net', 'RegNet', 'ResNeSt', 'HRNet',
                  'HourglassNet', 'Darknet', 'SSDVGG')})

__all__ = ['ResNet', 'BasicBlock', 'Bottleneck']
