"""The plain reference of SS-HSLIE's network: DecompositionNet,
IllumAdjustmentNet with its TransformerBlock, and S = R·ΔI + R·I
(reference model.py:17-234), in plain PyTorch over a dict of parameters.

Float32 throughout; the caller turns both TF32 switches off. Nothing here is
a kernel: ``F.conv2d``, ``F.conv_transpose2d``, ``F.linear``, a softmax over
the full (S, S) logits and ``F.interpolate(mode="nearest")``. ``rnd`` rounds
every operand of a product (convolutions, linears, both products of the
attention) to a lower precision (``precision.py``): the controls.

Tensors are NCHW inside, NHWC at the model's boundary, as the loss reads
them. Parameter names are the reference's state-dict keys.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .precision import rounded

Params = Dict[str, torch.Tensor]


def layer_table(bands: int, channel: int = 64, heads: int = 4, head_dim: int = 16,
                ff_dim: int = 64) -> "OrderedDict[str, tuple]":
    """name -> (kind, c_in, c_out, k, stride) of every layer with weights,
    in forward order; kind is conv, convT or linear."""
    ch = channel
    d, i = "decomposition_net.", "illum_adjust_net."
    rows = [
        (d + "conv0.0", "conv", bands, ch // 2, 3, 1),
        (d + "shallow_conv.0", "conv", bands, ch, 9, 1),
        (d + "conv1.0", "conv", ch, ch, 3, 1),
        (d + "conv2.0", "conv", ch, ch * 2, 3, 2),
        (d + "conv3.0", "conv", ch * 2, ch * 2, 3, 1),
        (d + "deconv.0", "convT", ch * 2, ch, 3, 2),
        (d + "conv5.0", "conv", ch * 2, ch, 3, 1),
        (d + "conv7.0", "conv", ch + ch // 2, ch, 3, 1),
        (d + "recon", "conv", ch, bands + 1, 3, 1),
        (i + "conv0.0", "conv", bands + 1, ch, 3, 1),
        (i + "conv1.0", "conv", ch, ch, 3, 2),
        (i + "conv2.0", "conv", ch, ch, 3, 2),
        (i + "conv3.0", "conv", ch, ch, 3, 2),
        (i + "attn.q_linear", "linear", ch, heads * head_dim, 1, 1),
        (i + "attn.k_linear", "linear", ch, heads * head_dim, 1, 1),
        (i + "attn.v_linear", "linear", ch, heads * head_dim, 1, 1),
        (i + "attn.ff_linear1", "linear", heads * head_dim, ff_dim, 1, 1),
        (i + "attn.ff_linear2", "linear", ff_dim, ch, 1, 1),
        (i + "deconv1.0", "conv", ch, ch, 3, 1),
        (i + "deconv2.0", "conv", ch, ch, 3, 1),
        (i + "deconv3.0", "conv", ch, ch, 3, 1),
        (i + "feature_fusion.0", "conv", ch * 3, ch, 1, 1),
        (i + "final_conv", "conv", ch, 1, 3, 1),
    ]
    return OrderedDict((r[0], r[1:]) for r in rows)


def param_shapes(bands: int, channel: int = 64, heads: int = 4, head_dim: int = 16,
                 ff_dim: int = 64) -> "OrderedDict[str, tuple]":
    """state-dict key -> (shape, fan_in): PyTorch's layouts (conv OIHW,
    transposed conv IOHW, linear (out, in)) and its default init envelope
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias alike."""
    out = OrderedDict()
    for name, (kind, ci, co, k, _) in layer_table(bands, channel, heads, head_dim,
                                                  ff_dim).items():
        if kind == "conv":
            shape, fan_in = (co, ci, k, k), ci * k * k
        elif kind == "convT":
            # PyTorch's ConvTranspose2d init takes fan_in = weight.size(1) * k * k.
            shape, fan_in = (ci, co, k, k), co * k * k
        else:
            shape, fan_in = (co, ci), ci
        out[name + ".weight"] = (shape, fan_in)
        out[name + ".bias"] = ((co,), fan_in)
    return out


class Reference:
    """The forward of the network over ``params``; ``rnd`` rounds the
    operands of every product (None: float32)."""

    def __init__(self, params: Params, bands: int, heads: int = 4, head_dim: int = 16,
                 rnd: Optional[str] = None):
        self.p, self.bands, self.heads, self.head_dim, self.rnd = params, bands, heads, head_dim, rnd

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return rounded(t, self.rnd)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        w = self.p[name + ".weight"]
        pad = (w.shape[-1] - 1) // 2
        return F.conv2d(self._q(x), self._q(w), self.p[name + ".bias"], stride=stride, padding=pad)

    def conv_t(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(self._q(x), self._q(self.p[name + ".weight"]),
                                  self.p[name + ".bias"], stride=2, padding=1, output_padding=1)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self._q(x), self._q(self.p[name + ".weight"]), self.p[name + ".bias"])

    def decompose(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW cube -> (R, L), NCHW."""
        d = "decomposition_net."
        conv0 = F.relu(self.conv(d + "conv0.0", x))
        shallow = self.conv(d + "shallow_conv.0", x)
        conv1 = F.relu(self.conv(d + "conv1.0", shallow))
        conv2 = F.relu(self.conv(d + "conv2.0", conv1, stride=2))
        conv3 = F.relu(self.conv(d + "conv3.0", conv2))
        deconv = F.relu(self.conv_t(d + "deconv.0", conv3))[:, :, : conv1.shape[2], : conv1.shape[3]]
        conv5 = F.relu(self.conv(d + "conv5.0", torch.cat([deconv, conv1], dim=1)))
        conv7 = self.conv(d + "conv7.0", torch.cat([conv5, conv0], dim=1))
        recon = self.conv(d + "recon", conv7)
        return torch.sigmoid(recon[:, : self.bands]), torch.sigmoid(recon[:, self.bands:])

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The TransformerBlock (reference model.py:87-119): no positional
        encoding, no LayerNorm, the FF output added to the input tokens."""
        a = "illum_adjust_net.attn."
        b, c, h, w = x.shape
        s, nh, hd = h * w, self.heads, self.head_dim
        tokens = x.permute(0, 2, 3, 1).reshape(b, s, c)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, s, nh, hd).transpose(1, 2)

        q = heads(self.linear(a + "q_linear", tokens))
        k = heads(self.linear(a + "k_linear", tokens))
        v = heads(self.linear(a + "v_linear", tokens))
        logits = torch.matmul(self._q(q), self._q(k).transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.matmul(self._q(torch.softmax(logits, dim=-1)), self._q(v))
        attn = attn.transpose(1, 2).reshape(b, s, nh * hd)
        ff = self.linear(a + "ff_linear2", F.relu(self.linear(a + "ff_linear1", attn)))
        return (tokens + ff).reshape(b, h, w, c).permute(0, 3, 1, 2)

    def adjust(self, I: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        """IllumAdjustmentNet (reference model.py:121-175) -> I_delta, NCHW."""
        i = "illum_adjust_net."
        conv0 = self.conv(i + "conv0.0", torch.cat([R, I], dim=1))
        conv1 = F.relu(self.conv(i + "conv1.0", conv0, stride=2))
        conv2 = F.relu(self.conv(i + "conv2.0", conv1, stride=2))
        conv3 = self.attend(F.relu(self.conv(i + "conv3.0", conv2, stride=2)))

        def up(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
            return F.interpolate(t, size=like.shape[2:], mode="nearest")

        deconv1 = F.relu(self.conv(i + "deconv1.0", up(conv3, conv2))) + conv2
        deconv2 = F.relu(self.conv(i + "deconv2.0", up(deconv1, conv1))) + conv1
        deconv3 = F.relu(self.conv(i + "deconv3.0", up(deconv2, conv0))) + conv0
        gather = torch.cat([up(deconv1, conv0), up(deconv2, conv0), deconv3], dim=1)
        return self.conv(i + "final_conv", self.conv(i + "feature_fusion.0", gather))

    def forward(self, x_nhwc: torch.Tensor):
        """(B, H, W, C) -> (R_low, I_low, I_delta, S), each NHWC."""
        R, I = self.decompose(x_nhwc.permute(0, 3, 1, 2))
        I_delta = self.adjust(I, R)
        S = R * I_delta + R * I
        return tuple(t.permute(0, 2, 3, 1) for t in (R, I, I_delta, S))

    def forward_with_redecomposition(self, x_nhwc: torch.Tensor):
        """The forward plus R of the decomposition of S (reference model.py:545-546)."""
        R, I, I_delta, S = self.forward(x_nhwc)
        R_enh, _ = self.decompose(S.permute(0, 3, 1, 2))
        return R, I, I_delta, S, R_enh.permute(0, 2, 3, 1)
