"""Backbone block plugins (port of `ld_tpu/models/backbones/plugins.py`),
NCHW: GCNet's `ContextBlock` and the empirical-attention
`GeneralizedAttention`, under mmcv's module names so that published GCNet
and attention checkpoints load.

  * `ContextBlock`: attention-pooled ('att': a 1x1 `conv_mask`, softmax over
    the map) or mean-pooled ('avg') global context, then per fusion a
    1x1 conv to max(int(C x ratio), 1) channels, a LayerNorm over those
    channels (eps 1e-5), ReLU and a zero-init 1x1 conv back to C
    (`channel_add_conv.{0,1,3}` / `channel_mul_conv.{0,1,3}`): added to
    every position ('channel_add') or a sigmoid gate ('channel_mul'). The
    fusions apply in config order, as the JAX block does; mmcv gates
    first, then adds (ROADMAP.md caveat 40: the two differ only with both
    fusions, which no config sets).
  * `GeneralizedAttention`: multi-head attention whose energy sums the
    terms that `attention_type`'s four bits select: query x key content,
    query x relative-position embedding, a learned bias (`appr_bias`) x key
    content, a learned bias (`geom_bias`) x position; `q_stride` /
    `kv_stride` subsample the queries / keys and values by max pools
    (the JAX block's; mmcv takes every stride-th pixel: ROADMAP.md caveat
    38), the output is upsampled back by nearest neighbours, projected by
    `proj_conv` and added to the input times `gamma` (zero at init: the
    block starts as the identity). `spatial_range >= 0` limits each query
    to the keys within that many input pixels, by -1e9 energies; mmcv
    keeps that mask as a `local_constraint_map` parameter, the port
    computes it (no such key). `appr_bias` / `geom_bias` are mmcv's flat
    (heads x dim) vectors.

Both compute in their parameters' dtype promoted with their input's, as the
JAX blocks do: a bf16 trunk's activations meet float32 parameters, so the
blocks compute in float32 and return float32.
"""
from __future__ import annotations

import math
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ld_tpu_torch.models.layers import lecun_normal_
from ld_tpu_torch.models.necks.fpn import upsample_nearest_to

PLUGIN_POSITIONS = ('after_conv1', 'after_conv2', 'after_conv3')


def promoted(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """`x` in the dtype its and `module`'s parameters' promote to (flax's
    promotion of a module's input with its parameters)."""
    dtype = torch.promote_types(x.dtype, next(module.parameters()).dtype)
    return x.to(dtype)


class ContextBlock(nn.Module):
    """GCNet's global-context block (in and out channels `in_channels`)."""
    abbr = 'context_block'

    def __init__(self, in_channels: int, ratio: float = 1.0 / 4,
                 pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add', )):
        super().__init__()
        if pooling_type not in ('att', 'avg'):
            raise ValueError(f'ContextBlock pooling_type {pooling_type!r}')
        fusion_types = tuple(fusion_types)
        if not fusion_types or not set(fusion_types) <= {'channel_add',
                                                         'channel_mul'}:
            raise ValueError(f'ContextBlock fusion_types {fusion_types!r}')
        self.pooling_type = pooling_type
        self.fusion_types = fusion_types
        planes = max(int(in_channels * ratio), 1)
        if pooling_type == 'att':
            self.conv_mask = nn.Conv2d(in_channels, 1, 1)
        for fusion in fusion_types:
            self.add_module(f'{fusion}_conv', nn.Sequential(
                nn.Conv2d(in_channels, planes, 1),
                nn.LayerNorm([planes, 1, 1], eps=1e-5),
                nn.ReLU(inplace=True),
                nn.Conv2d(planes, in_channels, 1)))

    def init_weights(self, generator: torch.Generator):
        """The JAX block's initializers: lecun-normal kernels, zero biases,
        LayerNorm 1 / 0, each fusion's last conv zero."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    lecun_normal_(m.weight, generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
            for fusion in self.fusion_types:
                last = getattr(self, f'{fusion}_conv')[3]
                nn.init.zeros_(last.weight)

    def forward(self, x):
        x = promoted(x, self)
        b, c, h, w = x.shape
        if self.pooling_type == 'att':
            attn = torch.softmax(self.conv_mask(x).view(b, 1, h * w), dim=2)
            context = torch.matmul(x.view(b, c, h * w),
                                   attn.transpose(1, 2)).view(b, c, 1, 1)
        else:
            context = x.mean(dim=(2, 3), keepdim=True)
        out = x
        for fusion in self.fusion_types:
            t = getattr(self, f'{fusion}_conv')(context)
            out = out * torch.sigmoid(t) if fusion == 'channel_mul' \
                else out + t
        return out


def position_embedding(h, w, h_kv, w_kv, q_stride, kv_stride, feat_dim,
                       magnitude, wave_length=1000):
    """Sine / cosine embeddings of the relative x and y offsets between the
    query and key grids, in numpy (a copy of `ld_tpu/models/backbones/
    plugins.py:69-86`): (w, w_kv, D/2) and (h, h_kv, D/2) float32."""
    h_idxs = np.arange(h, dtype=np.float32)[:, None] * q_stride
    w_idxs = np.arange(w, dtype=np.float32)[:, None] * q_stride
    h_kv_idxs = np.arange(h_kv, dtype=np.float32)[:, None] * kv_stride
    w_kv_idxs = np.arange(w_kv, dtype=np.float32)[:, None] * kv_stride

    h_diff = (h_idxs[:, None, :] - h_kv_idxs[None, :, :]) * magnitude
    w_diff = (w_idxs[:, None, :] - w_kv_idxs[None, :, :]) * magnitude

    feat_range = np.arange(feat_dim // 4, dtype=np.float32)
    dim_mat = np.power(wave_length, (4.0 / feat_dim) * feat_range)
    emb_x = np.concatenate([np.sin(w_diff / dim_mat),
                            np.cos(w_diff / dim_mat)], axis=2)
    emb_y = np.concatenate([np.sin(h_diff / dim_mat),
                            np.cos(h_diff / dim_mat)], axis=2)
    return emb_x, emb_y


def local_mask(hq, wq, hk, wk, q_stride, kv_stride, spatial_range):
    """(hq*wq, hk*wk) bool: whether a key lies within `spatial_range`
    input pixels of the query in y and in x."""
    qyy = np.repeat(np.arange(hq) * q_stride, wq)
    qxx = np.tile(np.arange(wq) * q_stride, hq)
    kyy = np.repeat(np.arange(hk) * kv_stride, wk)
    kxx = np.tile(np.arange(wk) * kv_stride, hk)
    return ((np.abs(qyy[:, None] - kyy[None, :]) <= spatial_range) &
            (np.abs(qxx[:, None] - kxx[None, :]) <= spatial_range))


class GeneralizedAttention(nn.Module):
    """The empirical-attention block (in and out channels `in_channels`)."""
    abbr = 'gen_attention_block'

    def __init__(self, in_channels: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: int = 1, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = '1111'):
        super().__init__()
        if len(attention_type) != 4 or set(attention_type) - {'0', '1'}:
            raise ValueError(f'attention_type {attention_type!r}')
        self.at = [c == '1' for c in attention_type]
        self.num_heads = num_heads
        self.qk_dim = in_channels // num_heads
        self.spatial_range = spatial_range
        self.position_magnitude = position_magnitude
        self.kv_stride, self.q_stride = kv_stride, q_stride
        self.pe_dim = position_embedding_dim \
            if position_embedding_dim > 0 else in_channels
        out_c = self.qk_dim * num_heads
        at = self.at
        if at[0] or at[1]:
            self.query_conv = nn.Conv2d(in_channels, out_c, 1, bias=False)
        if at[0] or at[2]:
            self.key_conv = nn.Conv2d(in_channels, out_c, 1, bias=False)
        self.value_conv = nn.Conv2d(in_channels, out_c, 1, bias=False)
        if at[1] or at[3]:
            self.appr_geom_fc_x = nn.Linear(self.pe_dim // 2, out_c,
                                            bias=False)
            self.appr_geom_fc_y = nn.Linear(self.pe_dim // 2, out_c,
                                            bias=False)
        if at[2]:
            self.appr_bias = nn.Parameter(torch.zeros(out_c))
        if at[3]:
            self.geom_bias = nn.Parameter(torch.zeros(out_c))
        self.proj_conv = nn.Conv2d(out_c, in_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_weights(self, generator: torch.Generator):
        """The JAX block's initializers: lecun-normal convs and position
        FCs, zero `proj_conv` bias, the biases N(0, 1/dim), `gamma` 0."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    lecun_normal_(m.weight, generator)
            nn.init.zeros_(self.proj_conv.bias)
            for name in ('appr_bias', 'geom_bias'):
                if hasattr(self, name):
                    nn.init.normal_(getattr(self, name), 0.0,
                                    1.0 / math.sqrt(self.qk_dim),
                                    generator=generator)
            self.gamma.zero_()

    def _heads(self, t):
        """(B, heads*d, H, W) -> (B, heads, H*W, d)."""
        b = t.shape[0]
        return t.reshape(b, self.num_heads, self.qk_dim, -1).transpose(2, 3)

    def forward(self, x):
        x = promoted(x, self)
        b, c, h, w = x.shape
        at, n, d = self.at, self.num_heads, self.qk_dim
        x_q = F.max_pool2d(x, self.q_stride) if self.q_stride > 1 else x
        x_kv = F.max_pool2d(x, self.kv_stride) if self.kv_stride > 1 else x
        hq, wq = x_q.shape[-2:]
        hk, wk = x_kv.shape[-2:]
        scale = 1.0 / math.sqrt(d)

        query = self._heads(self.query_conv(x_q)) if at[0] or at[1] \
            else None                                     # (B, n, Q, d)
        key = self._heads(self.key_conv(x_kv)) if at[0] or at[2] else None
        if at[2]:
            appr_bias = self.appr_bias.view(1, n, 1, d)
        if at[0]:
            q = query + appr_bias if at[2] else query
            energy = torch.matmul(q, key.transpose(2, 3)) * scale
        elif at[2]:
            energy = torch.matmul(appr_bias.expand(b, n, 1, d),
                                  key.transpose(2, 3)) * scale
            energy = energy.expand(b, n, hq * wq, hk * wk)
        else:
            energy = x.new_zeros(b, n, hq * wq, hk * wk)

        if at[1] or at[3]:
            emb_x, emb_y = (torch.from_numpy(e).to(x.device)
                            for e in position_embedding(
                                hq, wq, hk, wk, self.q_stride,
                                self.kv_stride, self.pe_dim,
                                self.position_magnitude))
            feat_x = self.appr_geom_fc_x(emb_x).view(wq, wk, n, d) / \
                math.sqrt(2)
            feat_y = self.appr_geom_fc_y(emb_y).view(hq, hk, n, d) / \
                math.sqrt(2)
            if at[1]:
                q = query.reshape(b, n, hq, wq, d)
                if at[3]:
                    q = q + self.geom_bias.view(1, n, 1, 1, d)
            else:
                q = self.geom_bias.view(1, n, 1, 1, d).expand(b, n, hq, wq, d)
            e_x = torch.einsum('bnhwd,wvnd->bnhwv', q, feat_x) * scale
            e_y = torch.einsum('bnhwd,hund->bnhwu', q, feat_y) * scale
            pos = e_x[:, :, :, :, None, :] + e_y[:, :, :, :, :, None]
            energy = energy + pos.reshape(b, n, hq * wq, hk * wk)

        if self.spatial_range >= 0:
            ok = torch.from_numpy(local_mask(
                hq, wq, hk, wk, self.q_stride, self.kv_stride,
                self.spatial_range)).to(x.device)
            energy = torch.where(ok, energy, energy.new_tensor(-1e9))

        attention = torch.softmax(energy, dim=3)
        value = self._heads(self.value_conv(x_kv))         # (B, n, K, d)
        out = torch.matmul(attention, value)               # (B, n, Q, d)
        out = out.transpose(2, 3).reshape(b, n * d, hq, wq)
        if self.q_stride > 1:
            out = upsample_nearest_to(out, h, w)
        return x + self.gamma * self.proj_conv(out)


PLUGINS = {'ContextBlock': ContextBlock,
           'GeneralizedAttention': GeneralizedAttention}


def build_plugin(cfg: dict, in_channels: int) -> nn.Module:
    """A plugin module from its config dict (`type` and the block's
    keyword arguments) on `in_channels` channels."""
    cfg = dict(cfg)
    t = cfg.pop('type')
    if t not in PLUGINS:
        raise KeyError(f'unknown backbone plugin type {t!r} '
                       f'(known: {sorted(PLUGINS)})')
    return PLUGINS[t](in_channels, **cfg)


def stage_plugins(plugins, stage: int) -> list:
    """The plugin dicts active in `stage` (0-based): those whose `stages`
    flag is set there, or that have none (every stage), in config order."""
    out = []
    for p in plugins or ():
        if p.get('position') not in PLUGIN_POSITIONS:
            raise ValueError(f"plugin position {p.get('position')!r}")
        stages = p.get('stages')
        if stages is None or stages[stage]:
            out.append(p)
    return out


def warn_basic_block_plugins(depth: int):
    warnings.warn(
        f'ResNet-{depth} has BasicBlocks, which take no plugins: they are '
        'dropped, as the JAX package drops them (ROADMAP.md Queue C, '
        'caveat 39)', stacklevel=3)
