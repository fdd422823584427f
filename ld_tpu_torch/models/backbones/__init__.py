from .resnet import BasicBlock, Bottleneck, ResNet

__all__ = ['ResNet', 'BasicBlock', 'Bottleneck']
