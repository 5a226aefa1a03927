"""The plain reference of a training step and of a served request.

* :func:`draws` is the fused pipeline's table of one epoch's crops: offsets
  in [0, dim - patch) and one of the 8 flip/rotation modes a sample, from
  ``numpy.random.default_rng(SeedSequence([seed, epoch]))``.
* :func:`batch` crops and augments a step's samples from the cube stack:
  sample i of step ``b`` reads cube ``(b * B + i) % N`` (reference
  utils.py:7-34 for the modes).
* :class:`Adam` is Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) in
  PyTorch's arithmetic; :func:`step_lr` is StepLR stepped once an epoch.
* :func:`train` runs the first steps of epoch 0 from given weights and
  returns each step's terms, the first step's gradients and the weights
  after the last step.
* :func:`normalise` and :func:`enhance` are the served path: 12-bit counts
  -> global normalisation (clamped at 0, then divided by the cube's own max,
  as the reference's loader does) -> the forward -> S in counts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import loss as ref_loss
from .model import Params, Reference

NUM_MODES = 8


def draws(seed: int, epoch: int, num_batches: int, batch_size: int, hw, patch: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    size = (num_batches, batch_size)
    xs = rng.integers(0, max(hw[0] - patch, 1), size=size)
    ys = rng.integers(0, max(hw[1] - patch, 1), size=size)
    modes = rng.integers(0, NUM_MODES, size=size)
    return np.stack([xs, ys, modes], axis=-1)


def augment(p: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode 0 identity, 1 flipud, 2 rot90, 3 rot90 + flipud, 4 rot180,
    5 rot180 + flipud, 6 rot270, 7 rot270 + flipud, on (H, W, C)."""
    p = torch.rot90(p, k=mode // 2, dims=(0, 1))
    return torch.flip(p, dims=(0,)) if mode % 2 else p


def batch(cubes: torch.Tensor, rows: np.ndarray, batch_start: int, patch: int) -> torch.Tensor:
    n = cubes.shape[0]
    out = [augment(cubes[(batch_start + i) % n, x:x + patch, y:y + patch], int(m))
           for i, (x, y, m) in enumerate(rows.tolist())]
    return torch.stack(out)


def step_lr(epoch: int, start_lr: float, gamma: float, period: int) -> float:
    return start_lr * gamma ** (epoch // period)


class Adam:
    def __init__(self, params: List[torch.Tensor], betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, (self.b1, self.b2), self.eps, self.t = params, betas, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(self.eps), value=-lr / c1)


def train(params0: Params, cubes: torch.Tensor, bands: int, seed: int, batch_size: int,
          patch: int, coeffs: Dict[str, float], lr: float, steps: int,
          rnd: Optional[str] = None, half_batch: bool = False):
    """The first ``steps`` steps of epoch 0 from ``params0`` (left as it is)
    -> ([terms of each step], first step's gradients, weights after).
    ``rnd`` rounds every product's operands (the control); ``half_batch``
    keeps only the first half of each batch (a fault's reading)."""
    names = list(params0)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    net = Reference(params, bands, rnd=rnd)
    opt = Adam([params[k] for k in names])
    n = cubes.shape[0]
    table = draws(seed, 0, n // batch_size, batch_size, tuple(cubes.shape[1:3]), patch)
    terms_each, first_grads = [], None
    for b in range(steps):
        x = batch(cubes, table[b], b * batch_size, patch)
        if half_batch:
            x = x[: max(batch_size // 2, 1)]
        tot, terms = ref_loss.total(x, *net.forward_with_redecomposition(x), coeffs)
        grads = torch.autograd.grad(tot, [params[k] for k in names])
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        opt.step(list(grads), lr)
        terms_each.append({k: float(v.detach()) for k, v in terms.items()})
    return terms_each, first_grads, {k: v.detach() for k, v in params.items()}


def normalise(counts: torch.Tensor, gmin: float, gmax: float) -> torch.Tensor:
    x = torch.clamp_min((counts.float() - gmin) / (gmax - gmin), 0.0)
    return x / torch.max(x)


@torch.no_grad()
def enhance(params: Params, counts: torch.Tensor, bands: int, gmin: float, gmax: float,
            rnd: Optional[str] = None) -> torch.Tensor:
    """One (H, W, C) cube of counts -> S (H, W, C) in counts, float32."""
    x = normalise(counts, gmin, gmax)[None]
    S = Reference(params, bands, rnd=rnd).forward(x)[3][0]
    return S * (gmax - gmin) + gmin
