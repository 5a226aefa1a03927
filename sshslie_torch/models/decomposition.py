"""Retinex decomposition network, as ``sshslie_tpu/models/decomposition.py``.

Architecture (channel counts for channel=64, C = spectral bands):

    x (B,C,H,W)
    ├─ conv0:    3×3 conv → 32, ReLU                  (skip to tail)
    └─ shallow:  9×9 conv → 64, linear                (the CUDA kernel, 64 bands)
       conv1:    3×3 conv → 64, ReLU                  (skip to mid)
       conv2:    3×3 conv s2 → 128, ReLU              (H/2, W/2)
       conv3:    3×3 conv → 128, ReLU
       deconv:   3×3 transpose-conv s2 → 64, ReLU     (back to H, W, cropped)
       concat(deconv, conv1) → conv5: 3×3 → 64, ReLU
       concat(conv5, conv0)  → conv7: 3×3 → 64, linear
       recon:    3×3 conv → C+1
    sigmoid (float32) split → R (B,C,H,W), L (B,1,H,W)

NCHW-shaped tensors with channels_last memory (see ``layers.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from sshslie_torch.models.layers import Conv2d, ConvTranspose2d, conv_block
from sshslie_torch.ops import at_least_float32


class DecompositionNet(nn.Module):
    """Two-scale CNN splitting a low-light cube into reflectance R and illumination L."""

    def __init__(self, in_channels: int, channel: int = 64, kernel_size: int = 3,
                 conv_impl: str = "torch", generator: Optional[torch.Generator] = None):
        super().__init__()
        ch, k, g = channel, kernel_size, generator
        self.in_channels = in_channels
        self.conv0 = conv_block(Conv2d(in_channels, ch // 2, k, generator=g), relu=True)
        self.shallow_conv = conv_block(
            Conv2d(in_channels, ch, k * 3, impl=conv_impl, generator=g), relu=False)
        self.conv1 = conv_block(Conv2d(ch, ch, k, generator=g), relu=True)
        self.conv2 = conv_block(Conv2d(ch, ch * 2, k, stride=2, generator=g), relu=True)
        self.conv3 = conv_block(Conv2d(ch * 2, ch * 2, k, generator=g), relu=True)
        self.deconv = conv_block(ConvTranspose2d(ch * 2, ch, k, stride=2, output_padding=1,
                                                 generator=g), relu=True)
        self.conv5 = conv_block(Conv2d(ch * 2, ch, k, generator=g), relu=True)
        self.conv7 = conv_block(Conv2d(ch + ch // 2, ch, k, generator=g), relu=False)
        self.recon = Conv2d(ch, in_channels + 1, k, generator=g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # Sigmoid in float32 at least, whatever the compute type.
        recon = at_least_float32(self.recon(self.features(x)))
        R = torch.sigmoid(recon[:, : self.in_channels])
        L = torch.sigmoid(recon[:, self.in_channels:])
        return R, L

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """conv0 to conv7: the (B, channel, H, W) features that recon reads."""
        conv0 = self.conv0(x)
        conv1 = self.conv1(self.shallow_conv(x))
        conv3 = self.conv3(self.conv2(conv1))
        # The transpose conv yields 2·ceil(H/2); crop to the skip's size so odd
        # inputs work, as the JAX package does (no-op for even sizes, and for
        # a rank's even share of the height).
        deconv = self.deconv(conv3)[:, :, : conv1.shape[2], : conv1.shape[3]]
        conv5 = self.conv5(torch.cat([deconv, conv1], dim=1))
        return self.conv7(torch.cat([conv5, conv0], dim=1))
