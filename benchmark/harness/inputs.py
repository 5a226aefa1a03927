"""The inputs a run makes from its seed, on the device: the weights and the
low-light cubes. Both sides of the comparison read these and nothing else.

* Weights: one uniform draw of every parameter at once from a
  ``torch.Generator`` on the device, each leaf scaled to PyTorch's default
  envelope U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``reference/model.py``).
* Cubes: 12-bit counts in [238, 4095] of a smooth scene under a dim,
  spatially varying illumination, plus sensor noise (the pattern of
  ``scripts/make_synthetic_dataset.py``, rewritten here for the device):
  reflectance 0.5 + 0.35 tanh(sum of 4 separable sinusoids with smooth
  spectral weights), illumination 0.05 to 0.25, noise of 6 counts.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import param_shapes

COUNT_MIN, COUNT_MAX = 238.0, 4095.0
NOISE_COUNTS = 6.0
COMPONENTS = 4


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed of its own for each purpose, from the run's seed."""
    return int(np.random.SeedSequence([int(seed), purpose]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def weights(seed: int, bands: int, device, **widths) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(bands, **widths)
    sizes = [int(np.prod(s)) for s, _ in shapes.values()]
    flat = torch.rand(sum(sizes), generator=generator(seed, 1, device), device=device)
    flat = flat.mul_(2.0).sub_(1.0)
    out = OrderedDict()
    for (name, (shape, fan_in)), part in zip(shapes.items(), flat.split(sizes)):
        out[name] = part.view(shape).mul_(1.0 / fan_in ** 0.5)
    return out


def counts(seed: int, purpose: int, n: int, h: int, w: int, bands: int, device) -> torch.Tensor:
    """(n, h, w, bands) float32 whole counts in [238, 4095]."""
    g = generator(seed, purpose, device)
    out = torch.empty((n, h, w, bands), device=device)
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xx = torch.linspace(0.0, 1.0, w, device=device)[None, :]
    lam = torch.linspace(0.0, 1.0, bands, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    for i in range(n):
        freq = 1.0 + 6.0 * rand(COMPONENTS, 2)
        phase = 6.2832 * rand(COMPONENTS, 3)
        spectral = torch.sin(6.2832 * (0.5 + rand(COMPONENTS, 1)) * lam + phase[:, 2:3])
        scene = torch.zeros((h, w, bands), device=device)
        for k in range(COMPONENTS):
            pattern = (torch.sin(6.2832 * freq[k, 0] * yy + phase[k, 0])
                       * torch.cos(6.2832 * freq[k, 1] * xx + phase[k, 1]))
            scene += pattern[:, :, None] * spectral[k]
        reflect = 0.5 + 0.35 * torch.tanh(scene)
        lf = 1.0 + 2.0 * rand(2)
        lp = 6.2832 * rand(2)
        illum = 0.05 + 0.2 * (0.5 + 0.5 * torch.sin(6.2832 * lf[0] * yy + lp[0])
                              * torch.cos(6.2832 * lf[1] * xx + lp[1]))
        noise = torch.randn((h, w, bands), generator=g, device=device) * NOISE_COUNTS
        cube = COUNT_MIN + (COUNT_MAX - COUNT_MIN) * reflect * illum[:, :, None] + noise
        out[i] = cube.round_().clamp_(COUNT_MIN, COUNT_MAX)
    return out


def normalise(cubes: torch.Tensor) -> torch.Tensor:
    """The loader's global normalisation of each cube: (x - 238) / (4095 -
    238), clamped at 0, then divided by the cube's own max, in place."""
    cubes.sub_(COUNT_MIN).div_(COUNT_MAX - COUNT_MIN).clamp_min_(0.0)
    peak = cubes.flatten(1).amax(dim=1)
    return cubes.div_(peak[:, None, None, None])
