"""Conv + BatchNorm folding; port of `ld_tpu/utils/fuse_conv_bn.py:32-103`.

At eval a BatchNorm computes y = (x - mean) * gamma / sqrt(var + eps) + beta.
When x is the output of a conv, or of a DCN conv (linear in its `weight`,
whatever its offsets), the factor f = gamma / sqrt(var + eps) folds into the
conv's output channels:

    weight' = weight * f
    and the BN is left as a bias add:
    weight_bn' = 1, bias' = beta - mean * f, mean' = 0, var' = 1 - eps

so the folded BN computes x * 1 / sqrt((1 - eps) + eps) + bias' = x + bias',
the unfolded function in exact arithmetic. The modules and their names stay
as they are, so a folded model still loads and saves the same state dict.

Never fold a weight-standardized conv (conv_cfg type 'ConvWS'): it
renormalises its weight per output channel, which undoes the fold while the
BN is still reset. `fuse_conv_bn_cfg_ok` is the gate.
"""
from __future__ import annotations

import torch
from torch import nn

from ld_tpu_torch.models.layers import ConvWS2d
from ld_tpu_torch.ops.deform_conv import ModulatedDeformConv2d


def fuse_conv_bn_cfg_ok(model_cfg) -> bool:
    """True when the model config has no ConvWS conv_cfg anywhere."""
    def scan(node):
        if isinstance(node, dict):
            if node.get('type') == 'ConvWS':
                return False
            return all(scan(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return all(scan(v) for v in node)
        return True
    return scan(model_cfg)


def _conv_of(parent: nn.Module, bn_name: str):
    """The conv a BN follows, by the port's names: `bnX` after `convX`, and
    in a `Sequential` (a `downsample`, the v1d deep `stem`) the child before
    it. A Res2Net block's split BNs (`bns`, a `ModuleList`) pair with none,
    as the JAX fold pairs only `*norm*` with `*conv*` and leaves `bnsI`."""
    if bn_name.startswith('bn'):
        conv = getattr(parent, 'conv' + bn_name[2:], None)
    elif isinstance(parent, nn.Sequential) and bn_name.isdigit() \
            and int(bn_name) > 0:
        conv = parent[int(bn_name) - 1]
    else:
        conv = None
    if isinstance(conv, ConvWS2d):
        return None     # it would standardize the folded weight away
    return conv if isinstance(conv, (nn.Conv2d, ModulatedDeformConv2d)) \
        else None


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every conv -> BatchNorm pair of `model` in place; returns the
    number of pairs folded. BNs that follow no conv are left as they are,
    and so are the BNs of a conv that several BNs follow (the shared tower
    convs of `RetinaSepBNHead`, one BN a level)."""
    pairs = []
    for parent in model.modules():
        for name, bn in parent.named_children():
            if not isinstance(bn, nn.BatchNorm2d):
                continue
            conv = _conv_of(parent, name)
            if conv is not None and conv.out_channels == bn.num_features:
                pairs.append((conv, bn))
    uses = {}
    for conv, _ in pairs:
        uses[id(conv)] = uses.get(id(conv), 0) + 1
    folded = 0
    for conv, bn in pairs:
        if uses[id(conv)] == 1:
            f = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            conv.weight.mul_(f[:, None, None, None])
            bn.bias.copy_(bn.bias - bn.running_mean * f)
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - bn.eps)
            folded += 1
    return folded
