"""Visualisation tools, as ``sshslie_tpu/viz.py``: the reference's MATLAB
figure scripts and the false-colour helper of plot_spectra.py:13-57.

* false- and true-colour composites, each display channel the band nearest
  a wavelength (indoor NIR 800 / red 670 / green 550, JYU 650/550/468, true
  colour 640/540/460), under the normalisation modes of
  visualizeHsiFalseColor_indoor.m:21-48;
* display ranges shared across a cube set (computeFalseColorDisplayParams.m);
* stretches (pctStretch.m, minMaxStretch.m);
* windowed-mean spectra at probe points (drag*.m, plot_spectra.py:300-320);
* comparison grids (compareResultsHoriz/Vert.m) and figure export.

The arrays are numpy. matplotlib is imported only where a figure renders
(:func:`_pyplot`), so the module imports where matplotlib is missing.

``python -m sshslie_torch.viz --cube a.mat --out figs --wave_start 414.63
--wave_end 985.05 [--preset indoor|jyu|true] [--grid]`` writes one PNG a
cube, or one grid.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _pyplot():
    """``matplotlib.pyplot``, headless (Agg) on Linux without a display and
    without ``MPLBACKEND``; elsewhere matplotlib picks its backend, so the
    inspector stays interactive where a display exists."""
    import matplotlib

    if (sys.platform.startswith("linux") and not os.environ.get("DISPLAY")
            and not os.environ.get("MPLBACKEND")):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# Band-picking presets (nm): (R, G, B) display channels.
FALSE_COLOR_INDOOR = (800.0, 670.0, 550.0)   # NIR/red/green (plot_spectra.py:38-40)
FALSE_COLOR_JYU = (650.0, 550.0, 468.0)      # visualizeHsiFalseColor_jyu.m:14-16
TRUE_COLOR = (640.0, 540.0, 460.0)           # visualizeHsiTrueColor.m:13-15


def _point_label(i: int) -> str:
    """a, b, ..., z, a1, b1, ... — probe labels beyond 26 points must not
    crash the export (letters[i] would IndexError)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    suffix = "" if i < 26 else str(i // 26)
    return letters[i % 26] + suffix


def pct_stretch(img: np.ndarray, low_pct: float = 2.0, high_pct: float = 98.0) -> np.ndarray:
    """Percentile clip + scale to [0,1] (pctStretch.m)."""
    lo, hi = np.percentile(img, [low_pct, high_pct])
    if hi <= lo:
        return np.zeros_like(img, dtype=np.float64)
    return np.clip((img - lo) / (hi - lo), 0.0, 1.0)


def min_max_stretch(cube: np.ndarray) -> np.ndarray:
    """Band-wise min-max stretch to [0,1] (minMaxStretch.m)."""
    mins = cube.min(axis=(0, 1), keepdims=True)
    maxs = cube.max(axis=(0, 1), keepdims=True)
    rng = np.where(maxs > mins, maxs - mins, 1.0)
    return (cube - mins) / rng


def band_indices_for_wavelengths(
    num_bands: int, wave_start_nm: float, wave_end_nm: float,
    targets_nm: Sequence[float],
) -> List[int]:
    """Nearest-band lookup on a linear wavelength axis (plot_spectra.py:34-40)."""
    wavelengths = np.linspace(wave_start_nm, wave_end_nm, num_bands)
    return [int(np.argmin(np.abs(wavelengths - t))) for t in targets_nm]


@dataclass
class DisplayParams:
    """Shared display ranges for consistent rendering across a cube set
    (computeFalseColorDisplayParams.m)."""

    channel_min: np.ndarray  # (3,)
    channel_max: np.ndarray  # (3,)
    gamma: float = 1.0


def compute_display_params(
    cubes: Sequence[np.ndarray],
    band_idx: Sequence[int],
    method: str = "fixedMax",
    pct: float = 99.0,
    gamma: float = 1.0,
) -> DisplayParams:
    """Global per-display-channel min/max across a set of cubes.

    method 'fixedMax' uses the global min/max; 'percentile' clips at ``pct``.
    """
    # Raveled concatenation, not np.stack: the cube set may mix spatial
    # sizes (e.g. a capture and its GT differing by a few pixels — exactly
    # the data the aligner exists for) and the reductions don't need a
    # common grid.
    chans = [np.concatenate([np.ravel(c[..., b]) for c in cubes])
             for b in band_idx]
    if method == "fixedMax":
        mins = np.array([ch.min() for ch in chans])
        maxs = np.array([ch.max() for ch in chans])
    elif method == "percentile":
        mins = np.array([np.percentile(ch, 100 - pct) for ch in chans])
        maxs = np.array([np.percentile(ch, pct) for ch in chans])
    else:
        raise ValueError(f"unknown method {method!r}")
    return DisplayParams(channel_min=mins, channel_max=maxs, gamma=gamma)


def false_color(
    cube: np.ndarray,
    wave_start_nm: float,
    wave_end_nm: float,
    targets_nm: Sequence[float] = FALSE_COLOR_INDOOR,
    normalization: str = "zeroOne",
    global_max: Optional[float] = None,
    display_params: Optional[DisplayParams] = None,
    gamma: float = 1.0,
) -> np.ndarray:
    """(H, W, 3) composite from nearest-wavelength bands.

    Normalization modes (visualizeHsiFalseColor_indoor.m:21-48):
      'none'            raw band values
      'zeroOne'         per-channel min-max to [0,1]
      'divideMax'       divide by the composite's max
      'divideGlobalMax' divide by a dataset-global max (``global_max``)
      'percClip'        2-98 percentile stretch per channel
      'shared'          use ``display_params`` ranges (+ gamma)
    """
    idx = band_indices_for_wavelengths(cube.shape[2], wave_start_nm, wave_end_nm, targets_nm)
    rgb = np.stack([cube[..., i] for i in idx], axis=-1).astype(np.float64)

    if normalization == "none":
        pass
    elif normalization == "zeroOne":
        rgb = min_max_stretch(rgb)
    elif normalization == "divideMax":
        m = rgb.max()
        rgb = rgb / m if m > 0 else rgb
    elif normalization == "divideGlobalMax":
        if global_max is None:
            raise ValueError("divideGlobalMax needs global_max")
        rgb = np.clip(rgb / global_max, 0.0, 1.0)
    elif normalization == "percClip":
        rgb = np.stack([pct_stretch(rgb[..., i]) for i in range(3)], axis=-1)
    elif normalization == "shared":
        if display_params is None:
            raise ValueError("'shared' needs display_params")
        rng = np.where(
            display_params.channel_max > display_params.channel_min,
            display_params.channel_max - display_params.channel_min, 1.0,
        )
        rgb = np.clip((rgb - display_params.channel_min) / rng, 0.0, 1.0)
        gamma = display_params.gamma
    else:
        raise ValueError(f"unknown normalization {normalization!r}")

    if gamma != 1.0:
        rgb = np.clip(rgb, 0.0, 1.0) ** (1.0 / gamma)
    return rgb


def true_color(cube: np.ndarray, wave_start_nm: float, wave_end_nm: float, **kw) -> np.ndarray:
    """True-color composite at 640/540/460 nm (visualizeHsiTrueColor.m)."""
    return false_color(cube, wave_start_nm, wave_end_nm, targets_nm=TRUE_COLOR, **kw)


def windowed_spectrum(
    cube: np.ndarray, x: int, y: int, window_size: int = 5
) -> np.ndarray:
    """Mean spectrum of a window centered at (x, y) — the probe-point measure
    of drag*.m / plot_spectra.py:305-318. (x = column, y = row, 0-based.)

    Matches the reference's sum/window² normalization, including its behavior
    at image borders where the clipped window still divides by window².
    """
    h, w, _ = cube.shape
    x_start = max(0, x - window_size // 2)
    x_end = min(w, x_start + window_size)
    y_start = max(0, y - window_size // 2)
    y_end = min(h, y_start + window_size)
    window = cube[y_start:y_end, x_start:x_end, :]
    return window.sum(axis=(0, 1)) / float(window_size**2)


def plot_spectra_at_points(
    cubes: Dict[str, np.ndarray],
    points: Sequence[Tuple[int, int]],
    save_dir: str,
    window_size: int = 5,
    highlight: Optional[Dict[str, dict]] = None,
    prefix: str = "spectrum",
    fmt: str = "png",
) -> List[str]:
    """One figure per probe point, each curve one algorithm's windowed-mean
    spectrum (plot_spectra.py:300-343). Returns written paths."""
    plt = _pyplot()
    os.makedirs(save_dir, exist_ok=True)
    highlight = highlight or {}
    written = []
    for i, (x, y) in enumerate(points):
        plt.figure(figsize=(16, 9))
        for label, cube in cubes.items():
            spectrum = windowed_spectrum(cube, x, y, window_size)
            style = highlight.get(label, {})
            plt.plot(spectrum, label=label, **style)
        plt.xlabel("Band Number")
        plt.ylabel("Intensity")
        plt.legend(loc="upper left", bbox_to_anchor=(1.01, 1.0), ncol=1)
        plt.tight_layout()
        path = os.path.join(save_dir, f"{prefix}_at_{_point_label(i)}.{fmt}")
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        written.append(path)
    return written


def save_false_color_figure(
    rgb: np.ndarray,
    save_path: str,
    points: Sequence[Tuple[int, int]] = (),
    title: Optional[str] = None,
    dpi: int = 300,
) -> str:
    """Render a composite with optional probe-point markers (plot_spectra.py
    figure block; saveFig_*.m pixel export)."""
    plt = _pyplot()
    plt.figure(figsize=(8, 6))
    plt.imshow(np.clip(rgb, 0, 1))
    plt.axis("off")
    if points:
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        plt.plot(xs, ys, "ro", markersize=8)
        for j, (x, y) in enumerate(points):
            plt.text(x + 15, y - 15, f"({_point_label(j)})", color="blue", fontsize=20,
                     weight="bold",
                     bbox=dict(facecolor="white", edgecolor="black",
                               boxstyle="round,pad=0.5", alpha=0.3))
    if title:
        plt.title(title)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close()
    return save_path


def comparison_grid(
    images: Dict[str, np.ndarray],
    save_path: str,
    ncols: Optional[int] = None,
    horizontal: bool = True,
    dpi: int = 200,
) -> str:
    """Side-by-side algorithm grid (compareResultsHoriz.m / compareResultsVert.m)."""
    n = len(images)
    if n == 0:
        raise ValueError("comparison_grid needs at least one image")
    if ncols is None:
        ncols = n if horizontal else 1
    nrows = -(-n // ncols)
    plt = _pyplot()
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax, (label, img) in zip(axes, images.items()):
        if img.ndim == 2:
            ax.imshow(img, cmap="gray")
        else:
            ax.imshow(np.clip(img, 0, 1))
        ax.set_title(label)
        ax.axis("off")
    for ax in axes[n:]:
        ax.axis("off")
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.tight_layout()
    plt.savefig(save_path, dpi=dpi, bbox_inches="tight")
    plt.close()
    return save_path


def main(argv=None):
    """Composite-export CLI — the visualizeHsi*(...) call surface
    (visualizeHsiFalseColor_indoor.m / _jyu.m / visualizeHsiTrueColor.m).

    One PNG per input cube; ``--preset`` picks the band triple, the
    normalization modes mirror visualizeHsiFalseColor_indoor.m:21-48.
    """
    import argparse

    from sshslie_torch.utils.io_hsi import load_cube_specs

    ap = argparse.ArgumentParser(description="Export false/true-color composites.")
    ap.add_argument("--cube", action="append", default=[],
                    help="'Label=path.mat' or bare path; repeatable")
    ap.add_argument("--experiment", default="",
                    help="experiment name from --registry; its captures are "
                         "prepended to --cube and its wavelength range fills "
                         "unset --wave_start/--wave_end (fetchExperimentData.m)")
    ap.add_argument("--registry", default="experiments.yml",
                    help="experiments YAML (see sshslie_torch/experiments.py)")
    ap.add_argument("--base_dir", default="",
                    help="prefix for the registry's capture paths")
    ap.add_argument("--out", required=True, help="output PNG (single cube) or directory")
    ap.add_argument("--wave_start", type=float, default=None)
    ap.add_argument("--wave_end", type=float, default=None)
    ap.add_argument("--preset", default="indoor", choices=("indoor", "jyu", "true"))
    ap.add_argument("--normalization", default="zeroOne",
                    choices=("none", "zeroOne", "divideMax", "divideGlobalMax",
                             "percClip", "shared"))
    ap.add_argument("--global_max", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--shared_method", default="fixedMax",
                    choices=("fixedMax", "percentile"),
                    help="display-params method when --normalization shared")
    ap.add_argument("--point", action="append", default=[],
                    help="'x,y' probe marker; repeatable")
    ap.add_argument("--grid", action="store_true",
                    help="multiple cubes: one comparison grid instead of one PNG each")
    ap.add_argument("--mat_key", default="")
    args = ap.parse_args(argv)
    from sshslie_torch.experiments import resolve_cli_experiment

    resolve_cli_experiment(args)

    targets = {"indoor": FALSE_COLOR_INDOOR, "jyu": FALSE_COLOR_JYU,
               "true": TRUE_COLOR}[args.preset]
    cubes = load_cube_specs(args.cube, mat_key=args.mat_key)
    if len(cubes) > 1 and not args.grid and args.out.endswith(".png"):
        ap.error(
            f"--out {args.out!r} names a single PNG but {len(cubes)} cubes "
            "were given; pass a directory, or --grid for one comparison figure"
        )

    dp = None
    if args.normalization == "shared":
        n_bands = next(iter(cubes.values())).shape[2]
        band_idx = band_indices_for_wavelengths(
            n_bands, args.wave_start, args.wave_end, targets
        )
        dp = compute_display_params(
            list(cubes.values()), band_idx, method=args.shared_method,
            gamma=args.gamma,
        )
    points = [tuple(int(v) for v in p.split(",")) for p in args.point]

    composites = {
        label: false_color(
            cube, args.wave_start, args.wave_end, targets_nm=targets,
            normalization=args.normalization, global_max=args.global_max,
            display_params=dp, gamma=args.gamma,
        )
        for label, cube in cubes.items()
    }
    if args.grid and len(composites) > 1:
        out = comparison_grid(composites, args.out if args.out.endswith(".png")
                              else os.path.join(args.out, "grid.png"))
        print(f"Wrote {out}")
        return [out]
    written = []
    for label, rgb in composites.items():
        out = (args.out if args.out.endswith(".png") and len(composites) == 1
               else os.path.join(args.out, f"{label}.png"))
        written.append(save_false_color_figure(rgb, out, points=points, title=label))
        print(f"Wrote {written[-1]}")
    return written


if __name__ == "__main__":
    main()
