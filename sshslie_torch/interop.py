"""Weights across frameworks: JAX param trees and the reference ``.pth`` format.

The port's copy of the layout mapping in ``sshslie_tpu/interop.py``
(``flax_params_to_torch_state_dict``):

  * Conv2d           HWIO (kh, kw, in, out) → OIHW (out, in, kh, kw)
  * ConvTranspose2d  HWIO (kh, kw, in, out) → IOHW (in, out, kh, kw)
  * Dense            (in, out)              → (out, in)

The keys are the reference's (``decomposition_net.conv0.0.weight``, …), which
are also the port's module names. Checkpoints are the reference ``.pth``
payload ``{epoch, model_state_dict, optimizer_state_dict}`` (reference
model.py:595-601), so a JAX run exported with
``scripts/export_torch_checkpoint.py`` tests in the port, and the reference
reads what the port writes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

_DECOM_CONVS = ("conv0", "shallow_conv", "conv1", "conv2", "conv3", "conv5", "conv7")
_ILLUM_CONVS = ("conv0", "conv1", "conv2", "conv3", "deconv1", "deconv2", "deconv3",
                "feature_fusion")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(_flatten(dict(v), key))
        else:
            flat[key] = v
    return flat


OIHW, IOHW, LINEAR = (3, 2, 0, 1), (2, 3, 0, 1), (1, 0)


def jax_layout(params: Dict[str, Any]) -> Dict[str, tuple]:
    """``{JAX layer path: (port module path, permutation)}`` for every layer of
    a JAX param tree: the layer's ``<path>.kernel`` becomes the port's
    ``<module>.weight`` by ``kernel.transpose(permutation)`` and its
    ``<path>.bias`` the port's ``<module>.bias``."""
    flat = _flatten(params)
    d, i = "decomposition_net", "illum_adjust_net"
    layout = {f"{d}.{name}": (f"{d}.{name}.0", OIHW) for name in _DECOM_CONVS}
    layout[f"{d}.deconv"] = (f"{d}.deconv.0", IOHW)
    layout[f"{d}.recon"] = (f"{d}.recon", OIHW)
    layout.update({f"{i}.{name}": (f"{i}.{name}.0", OIHW) for name in _ILLUM_CONVS})
    layout[f"{i}.final_conv"] = (f"{i}.final_conv", OIHW)
    if f"{i}.attn.q_linear.kernel" in flat:
        names = ("q_linear", "k_linear", "v_linear", "ff_linear1", "ff_linear2")
    elif f"{i}.attn.fc1.kernel" in flat:
        names = ("fc1", "fc2")
    else:
        names = ()
    layout.update({f"{i}.attn.{name}": (f"{i}.attn.{name}", LINEAR) for name in names})
    return layout


def jax_params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX param tree (nested dicts of arrays)."""
    p = {k: np.asarray(v, dtype=np.float32) for k, v in _flatten(params).items()}
    out: Dict[str, torch.Tensor] = {}
    for ours, (torch_prefix, perm) in jax_layout(params).items():
        out[torch_prefix + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(p[ours + ".kernel"].transpose(perm)))
        out[torch_prefix + ".bias"] = torch.from_numpy(p[ours + ".bias"].copy())
    return out


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    epoch: Optional[int] = None,
                    optimizer: Union[None, torch.optim.Optimizer, Dict[str, Any]] = None) -> str:
    """Write a reference-format ``.pth`` through a temporary file and an
    atomic rename. ``optimizer_state_dict`` is the given optimizer's real
    ``state_dict()`` (a trainer's Adam, for resume), or the given optimizer
    state dict (a host copy, for the background writer); without either it
    is a fresh Adam over as many parameters (empty moments), which the
    reference's ``load_checkpoint`` reads unconditionally (model.py:606)."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    if optimizer is None:
        optimizer = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1)) for _ in sd], lr=1e-3)
    opt_state = optimizer if isinstance(optimizer, dict) else optimizer.state_dict()
    payload: Dict[str, Any] = {"model_state_dict": sd,
                               "optimizer_state_dict": _plain_groups(_to_cpu(opt_state))}
    if epoch is not None:
        payload["epoch"] = int(epoch)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _plain_groups(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The optimizer state with its groups as Adam on the CPU keeps them: a
    capturable Adam's rate tensor (``train.capturable_adam``) as a number and
    ``capturable`` off, so the file is the same whichever device trained and
    loads on either (``Trainer.fit`` makes it capturable again on a card)."""
    if "param_groups" not in opt_state:
        return opt_state
    groups = []
    for group in opt_state["param_groups"]:
        group = dict(group)
        if isinstance(group.get("lr"), torch.Tensor):
            group["lr"] = group["lr"].item()
        if group.get("capturable"):
            group["capturable"] = False
        groups.append(group)
    return {**opt_state, "param_groups": groups}


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> Optional[int]:
    """Load a reference ``.pth`` (full checkpoint or bare state dict) into
    ``model`` with ``strict=True``, and its optimizer state into
    ``optimizer`` when one is given (a bare state dict has none: that
    raises). Returns the epoch, or None."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    epoch = None
    opt_state = None
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        epoch = int(ckpt["epoch"]) if "epoch" in ckpt else None
        opt_state = ckpt.get("optimizer_state_dict")
        ckpt = ckpt["model_state_dict"]
    model.load_state_dict(ckpt, strict=True)
    if optimizer is not None:
        if opt_state is None:
            raise ValueError(f"{path} holds no optimizer state: it can warm-start "
                             "(pretrained_model) but cannot resume training")
        optimizer.load_state_dict(opt_state)
    return epoch
