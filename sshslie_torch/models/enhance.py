"""Top-level enhancement model, S = R_low·I_delta + R_low·I_low, as
``sshslie_tpu/models/enhance.py`` and ``train.py::build_model``. The training
objective also re-decomposes S (reference model.py:545-546):
:meth:`LowLightEnhanceNet.forward_with_redecomposition`.

The public forward takes and returns NHWC batches, the JAX layout; inside,
the nets see NCHW-shaped channels_last views of them (see ``layers.py``).
Module names give the reference state-dict keys, so a reference ``.pth`` (or
one exported from the JAX package) loads with ``strict=True``.

``dtype`` is the layers' compute dtype (``precision: bfloat16``; see
``layers.py``); the nets return float32 whatever it is. ``remat`` wraps each
of the three sub-network applications of a training forward (decom(low),
illum, decom(S)) in ``torch.utils.checkpoint`` (JAX ``nn.remat`` of each
sub-network, ``enhance.py:33-57``): their activations are recomputed in the
backward instead of kept. It changes neither the result nor the state-dict
keys. ``tf32`` (``matmul_precision`` below float32) sets every Conv2d's
``tf32`` flag, as ``dtype`` sets their compute dtype: the shallow conv's
kernels then take their TF32 entries for float32 operands on the card.
:func:`shard_space` gives every layer that reads across rows a height
split (``parallel/spatial.py``): the forward then takes and returns the
rank's rows of each NHWC tensor.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from sshslie_torch.config import matmul_tf32
from sshslie_torch.device import resolve_device
from sshslie_torch.models.decomposition import DecompositionNet
from sshslie_torch.models.illum_adjust import IllumAdjustmentNet, SEBlock, TransformerBlock
from sshslie_torch.models.layers import Conv2d, ConvTranspose2d, Dense
from sshslie_torch.parallel.spatial import Shard

PRECISIONS = {"float32": None, "bfloat16": torch.bfloat16}


class LowLightEnhanceNet(nn.Module):
    """Retinex decomposition + illumination adjustment (reference model.py:177-234)."""

    space: Optional[Shard] = None

    def __init__(self, input_channels: int = 64, channel: int = 64,
                 use_attention: bool = False, use_transformer: bool = True,
                 attention_impl: str = "auto", conv_impl: str = "auto",
                 remat: bool = False, dtype: Optional[torch.dtype] = None,
                 tf32: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_channels = input_channels
        self.remat = remat
        self.decomposition_net = DecompositionNet(
            input_channels, channel=channel, conv_impl=conv_impl, generator=generator)
        self.illum_adjust_net = IllumAdjustmentNet(
            input_channels, channel=channel, use_attention=use_attention,
            use_transformer=use_transformer, attention_impl=attention_impl,
            generator=generator)
        for m in self.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d, Dense)):
                m.compute_dtype = dtype
            if isinstance(m, Conv2d):
                m.tf32 = tf32

    def _apply_net(self, net: nn.Module, *args: torch.Tensor):
        """One sub-network application, checkpointed under ``remat`` when
        autograd records it."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(net, *args, use_reentrant=False)
        return net(*args)

    def forward(self, input_low: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """input_low: (B, H, W, C) → (R_low, I_low, I_delta, S), each NHWC."""
        R_low, I_low = self._apply_net(self.decomposition_net, input_low.permute(0, 3, 1, 2))
        I_delta = self._apply_net(self.illum_adjust_net, I_low, R_low)
        S = R_low * I_delta + R_low * I_low
        return tuple(t.permute(0, 2, 3, 1) for t in (R_low, I_low, I_delta, S))

    def forward_with_redecomposition(self, input_low: torch.Tensor):
        """The forward plus the second decomposition of S used by the loss →
        (R_low, I_low, I_delta, S, R_enh), each NHWC."""
        R_low, I_low, I_delta, S = self(input_low)
        R_enh, _ = self._apply_net(self.decomposition_net, S.permute(0, 3, 1, 2))
        return R_low, I_low, I_delta, S, R_enh.permute(0, 2, 3, 1)


def shard_space(model: LowLightEnhanceNet, shard: Optional[Shard]) -> Optional[Shard]:
    """Split the model's height over ``shard`` (None: whole), as ``tf32`` is
    set: an attribute of every layer that reads across rows, so that
    ``remat``'s recomputation in the backward runs the same collectives.
    Returns the split it replaces."""
    previous = model.space
    for m in model.modules():
        if isinstance(m, (LowLightEnhanceNet, Conv2d, ConvTranspose2d, TransformerBlock,
                          SEBlock)):
            m.space = shard
    return previous


@contextlib.contextmanager
def sharded(model: nn.Module, shard: Optional[Shard]):
    """The model's height split set to ``shard`` inside the block and put
    back after it (nothing is touched when it is ``shard`` already)."""
    previous = getattr(model, "space", None)
    if previous == shard:
        yield
        return
    shard_space(model, shard)
    try:
        yield
    finally:
        shard_space(model, previous)


def build_model(cfg, channels: int, device: Union[None, str, torch.device] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> LowLightEnhanceNet:
    """The configured model (``precision``, ``matmul_precision``, ``remat``,
    the kernel switches) on ``device`` (default: ``cfg.device``, which means
    the CUDA card unless it says 'cpu'), in eval mode, or in train mode with
    ``train``. The net has no dropout and no batch norm, so the two modes
    compute the same function; the flag keeps ``model.training`` honest."""
    dev = resolve_device(cfg.device if device is None else device)
    model = LowLightEnhanceNet(
        input_channels=channels, use_attention=cfg.use_attention,
        use_transformer=cfg.use_transformer, attention_impl=cfg.attention_impl,
        conv_impl=cfg.conv_impl, remat=cfg.remat, dtype=PRECISIONS[cfg.precision],
        tf32=matmul_tf32(cfg.matmul_precision), generator=generator)
    return model.to(dev).train(train)
