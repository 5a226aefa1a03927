"""Top-level enhancement model, S = R_low·I_delta + R_low·I_low, as
``sshslie_tpu/models/enhance.py`` and ``train.py::build_model``. The training
objective also re-decomposes S (reference model.py:545-546):
:meth:`LowLightEnhanceNet.forward_with_redecomposition`.

The public forward takes and returns NHWC batches, the JAX layout; inside,
the nets see NCHW-shaped channels_last views of them (see ``layers.py``).
Module names give the reference state-dict keys, so a reference ``.pth`` (or
one exported from the JAX package) loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from sshslie_torch.device import resolve_device
from sshslie_torch.models.decomposition import DecompositionNet
from sshslie_torch.models.illum_adjust import IllumAdjustmentNet


class LowLightEnhanceNet(nn.Module):
    """Retinex decomposition + illumination adjustment (reference model.py:177-234)."""

    def __init__(self, input_channels: int = 64, channel: int = 64,
                 use_attention: bool = False, use_transformer: bool = True,
                 attention_impl: str = "auto", conv_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_channels = input_channels
        self.decomposition_net = DecompositionNet(
            input_channels, channel=channel, conv_impl=conv_impl, generator=generator)
        self.illum_adjust_net = IllumAdjustmentNet(
            input_channels, channel=channel, use_attention=use_attention,
            use_transformer=use_transformer, attention_impl=attention_impl,
            generator=generator)

    def forward(self, input_low: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """input_low: (B, H, W, C) → (R_low, I_low, I_delta, S), each NHWC."""
        R_low, I_low = self.decomposition_net(input_low.permute(0, 3, 1, 2))
        I_delta = self.illum_adjust_net(I_low, R_low)
        S = R_low * I_delta + R_low * I_low
        return tuple(t.permute(0, 2, 3, 1) for t in (R_low, I_low, I_delta, S))

    def forward_with_redecomposition(self, input_low: torch.Tensor):
        """The forward plus the second decomposition of S used by the loss →
        (R_low, I_low, I_delta, S, R_enh), each NHWC."""
        R_low, I_low, I_delta, S = self(input_low)
        R_enh, _ = self.decomposition_net(S.permute(0, 3, 1, 2))
        return R_low, I_low, I_delta, S, R_enh.permute(0, 2, 3, 1)


def build_model(cfg, channels: int, device: Union[None, str, torch.device] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> LowLightEnhanceNet:
    """The configured model on ``device`` (default: ``cfg.device``, which means
    the CUDA card unless it says 'cpu'), in eval mode, or in train mode with
    ``train``. The net has no dropout and no batch norm, so the two modes
    compute the same function; the flag keeps ``model.training`` honest."""
    if cfg.precision != "float32":
        raise NotImplementedError(
            f"precision {cfg.precision!r}: the port runs float32 only so far "
            "(bfloat16 is ROADMAP.md queue 1, item 5)")
    dev = resolve_device(cfg.device if device is None else device)
    model = LowLightEnhanceNet(
        input_channels=channels, use_attention=cfg.use_attention,
        use_transformer=cfg.use_transformer, attention_impl=cfg.attention_impl,
        conv_impl=cfg.conv_impl, generator=generator)
    return model.to(dev).train(train)
