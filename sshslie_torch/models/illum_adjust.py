"""Illumination adjustment network and its attention blocks, as
``sshslie_tpu/models/illum_adjust.py``.

TransformerBlock quirks kept on purpose (reference model.py:99-119, PARITY
#9): no positional encoding, no LayerNorm, and the residual adds the FF output
to the *input* tokens (the attention output reaches the residual only through
the FF). NCHW-shaped tensors with channels_last memory (see ``layers.py``).

Height sharding (``space`` set, see ``layers.py``): the TransformerBlock
gathers its input's rows from every rank (``gather_rows``), runs Q/K/V, the
attention and the FF over the whole H·W sequence, as on one device (so
``multi_head_attention``'s ``auto`` rule decides on the whole S), and keeps
its own rows: what GSPMD does with JAX's ``pallas_call``, which it cannot
partition. The SEBlock's squeeze is the mean over the ranks' means
(``space_mean``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from sshslie_torch.models.layers import Conv2d, Dense, conv_block, nearest_resize
from sshslie_torch.ops import at_least_float32
from sshslie_torch.ops.attention import multi_head_attention
from sshslie_torch.parallel.spatial import Shard, gather_rows, space_mean


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel gate (reference model.py:72-85)."""

    space: Optional[Shard] = None

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(channels, channels // reduction, generator=generator)
        self.fc2 = Dense(channels // reduction, channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.mean(dim=(2, 3))
        if self.space is not None:
            squeeze = space_mean(squeeze, self.space)
        excitation = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))
        return x * excitation[:, :, None, None]


class TransformerBlock(nn.Module):
    """Self-attention over the flattened H·W pixels (reference model.py:87-119)."""

    space: Optional[Shard] = None

    def __init__(self, channels: int, num_heads: int = 4, head_dim: int = 16,
                 ff_dim: int = 64, attention_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.num_heads, self.head_dim = channels, num_heads, head_dim
        self.attention_impl = attention_impl
        total, g = num_heads * head_dim, generator
        self.q_linear = Dense(channels, total, generator=g)
        self.k_linear = Dense(channels, total, generator=g)
        self.v_linear = Dense(channels, total, generator=g)
        self.ff_linear1 = Dense(total, ff_dim, generator=g)
        self.ff_linear2 = Dense(ff_dim, channels, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.channels:
            raise ValueError(f"TransformerBlock built for {self.channels} channels, "
                             f"got {x.shape[1]}")
        if self.space is None:
            return self._attend(x)
        rows = self.space.rows(self.space.size * x.shape[2])
        return self._attend(gather_rows(x, self.space))[:, :, rows]

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        s = h * w
        x_flat = x.permute(0, 2, 3, 1).reshape(b, s, c)

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2).contiguous()

        attn = multi_head_attention(split_heads(self.q_linear(x_flat)),
                                    split_heads(self.k_linear(x_flat)),
                                    split_heads(self.v_linear(x_flat)),
                                    impl=self.attention_impl)
        attn = attn.transpose(1, 2).reshape(b, s, self.num_heads * self.head_dim)
        ff = self.ff_linear2(torch.relu(self.ff_linear1(attn)))
        # The residual adds the FF output to the *input* tokens (reference model.py:117).
        out = x_flat + ff
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class IllumAdjustmentNet(nn.Module):
    """U-shaped illumination corrector with attention at H/8 (reference model.py:121-175).

    concat(R, I) → conv0 → 3× stride-2 down → attention → 3× (nearest-up +
    conv + additive skip) → multi-scale gather → 1×1 fuse → final 3×3 conv →
    I_delta (B, 1, H, W) in float32.
    """

    def __init__(self, in_channels: int, channel: int = 64, kernel_size: int = 3,
                 use_attention: bool = False, use_transformer: bool = True,
                 attention_impl: str = "auto", generator: Optional[torch.Generator] = None):
        super().__init__()
        ch, k, g = channel, kernel_size, generator
        self.in_channels = in_channels
        self.conv0 = conv_block(Conv2d(in_channels + 1, ch, k, generator=g), relu=False)
        self.conv1 = conv_block(Conv2d(ch, ch, k, stride=2, generator=g), relu=True)
        self.conv2 = conv_block(Conv2d(ch, ch, k, stride=2, generator=g), relu=True)
        self.conv3 = conv_block(Conv2d(ch, ch, k, stride=2, generator=g), relu=True)
        if use_attention:
            self.attn = SEBlock(ch, generator=g)
        elif use_transformer:
            self.attn = TransformerBlock(ch, attention_impl=attention_impl, generator=g)
        else:
            self.attn = None
        self.deconv1 = conv_block(Conv2d(ch, ch, k, generator=g), relu=True)
        self.deconv2 = conv_block(Conv2d(ch, ch, k, generator=g), relu=True)
        self.deconv3 = conv_block(Conv2d(ch, ch, k, generator=g), relu=True)
        self.feature_fusion = conv_block(Conv2d(ch * 3, ch, 1, generator=g), relu=False)
        self.final_conv = Conv2d(ch, 1, 3, generator=g)

    def forward(self, I: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        if R.shape[1] != self.in_channels:
            raise ValueError(f"IllumAdjustmentNet built for {self.in_channels}-band R, "
                             f"got {R.shape[1]}")
        return self.adjust(self.conv0(torch.cat([R, I], dim=1)))

    def adjust(self, conv0: torch.Tensor) -> torch.Tensor:
        """Everything after conv0: conv0's (B, channel, H, W) output -> I_delta."""
        conv1 = self.conv1(conv0)
        conv2 = self.conv2(conv1)
        conv3 = self.conv3(conv2)
        if self.attn is not None:
            conv3 = self.attn(conv3)
        deconv1 = self.deconv1(nearest_resize(conv3, conv2.shape[2:])) + conv2
        deconv2 = self.deconv2(nearest_resize(deconv1, conv1.shape[2:])) + conv1
        deconv3 = self.deconv3(nearest_resize(deconv2, conv0.shape[2:])) + conv0
        size = deconv3.shape[2:]
        gather = torch.cat([nearest_resize(deconv1, size), nearest_resize(deconv2, size),
                            deconv3], dim=1)
        out = self.final_conv(self.feature_fusion(gather))
        return at_least_float32(out)
