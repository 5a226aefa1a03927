"""Spectra inspector, as ``sshslie_tpu/inspect_spectra.py``: the reference's
draggable MATLAB probes (drag.m, drag2.m, drag3.m, drag_expCustom.m).

A matplotlib window shows false-colour composites of one or more cubes with
draggable probe markers beside a panel of the windowed-mean spectrum at each
probe across every cube (drag3.m's synchronised form). A white region, when
given, divides every spectrum by that region's mean spectrum (drag3.m's
white calibration). The window needs an interactive backend; ``--save``
renders the same figure to a PNG headless, and
:meth:`SpectraInspector.spectra` is the arrays without a figure.

``python -m sshslie_torch.inspect_spectra --cube GT=a.mat --wave_start
414.63 --wave_end 985.05 [--point x,y ...] [--save probes.png]``
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sshslie_torch.viz import _pyplot, false_color, windowed_spectrum


def white_reference(cubes: Dict[str, np.ndarray],
                    white_region: Tuple[int, int, int, int]) -> Dict[str, np.ndarray]:
    """Each cube's mean spectrum over ``white_region`` = (y0, y1, x0, x1)."""
    y0, y1, x0, x1 = white_region
    return {label: cube[y0:y1, x0:x1].mean(axis=(0, 1)) for label, cube in cubes.items()}


def probe_spectra(cubes: Dict[str, np.ndarray], points: Sequence[Sequence[int]],
                  window_size: int = 5,
                  white: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, List[np.ndarray]]:
    """The windowed-mean spectrum of each cube at each (x, y) probe, divided
    by ``white[label]`` (its non-positive bands by 1) when given."""
    out: Dict[str, List[np.ndarray]] = {}
    for label, cube in cubes.items():
        specs = []
        for x, y in points:
            s = windowed_spectrum(cube, x, y, window_size)
            if white is not None:
                denom = np.where(white[label] > 0, white[label], 1.0)
                s = s / denom
            specs.append(s)
        out[label] = specs
    return out


class SpectraInspector:
    """Draggable probe points over synchronized composites + live spectra."""

    def __init__(
        self,
        cubes: Dict[str, np.ndarray],
        wave_start_nm: float,
        wave_end_nm: float,
        points: Sequence[Tuple[int, int]] = ((10, 10),),
        window_size: int = 5,
        white_region: Optional[Tuple[int, int, int, int]] = None,  # (y0, y1, x0, x1)
        normalization: str = "zeroOne",
    ):
        plt = _pyplot()
        n_bands = {label: c.shape[2] for label, c in cubes.items()}
        if len(set(n_bands.values())) > 1:
            raise ValueError(
                "all cubes must share one band count for a common wavelength "
                f"axis; got {n_bands}"
            )
        self.cubes = cubes
        self.window_size = window_size
        self.wave_start = wave_start_nm
        self.wave_end = wave_end_nm
        self.points: List[List[int]] = [list(p) for p in points]
        self.white: Optional[Dict[str, np.ndarray]] = (
            None if white_region is None else white_reference(cubes, white_region))

        n = len(cubes)
        self.fig, axes = plt.subplots(1, n + 1, figsize=(5 * (n + 1), 5))
        self.img_axes = list(np.atleast_1d(axes))[:-1]
        self.spec_ax = np.atleast_1d(axes)[-1]
        self.markers = []
        for ax, (label, cube) in zip(self.img_axes, cubes.items()):
            rgb = false_color(cube, wave_start_nm, wave_end_nm,
                              normalization=normalization)
            ax.imshow(np.clip(rgb, 0, 1))
            ax.set_title(label)
            ax.axis("off")
            ms = [ax.plot([x], [y], "ro", markersize=8, picker=8)[0]
                  for x, y in self.points]
            self.markers.append(ms)
        self._dragging: Optional[int] = None
        self.fig.canvas.mpl_connect("button_press_event", self._on_press)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_motion)
        self.fig.canvas.mpl_connect("button_release_event", self._on_release)
        self._redraw_spectra()

    # -- event plumbing --
    def _nearest_point(self, x: float, y: float) -> Optional[int]:
        if not self.points:
            return None
        d = [np.hypot(px - x, py - y) for px, py in self.points]
        i = int(np.argmin(d))
        return i if d[i] < 15 else None

    def _on_press(self, event):
        if event.inaxes in self.img_axes and event.xdata is not None:
            self._dragging = self._nearest_point(event.xdata, event.ydata)

    def _on_motion(self, event):
        if self._dragging is None or event.inaxes not in self.img_axes:
            return
        if event.xdata is None:
            return
        self.points[self._dragging] = [int(event.xdata), int(event.ydata)]
        for ms in self.markers:
            ms[self._dragging].set_data([int(event.xdata)], [int(event.ydata)])
        self._redraw_spectra()

    def _on_release(self, _event):
        self._dragging = None

    # -- spectra --
    def spectra(self) -> Dict[str, List[np.ndarray]]:
        """Current windowed-mean spectra per cube per probe (calibrated if a
        white region was given)."""
        return probe_spectra(self.cubes, self.points, self.window_size, self.white)

    def _redraw_spectra(self):
        self.spec_ax.clear()
        n_bands = next(iter(self.cubes.values())).shape[2]
        x = np.linspace(self.wave_start, self.wave_end, n_bands)
        styles = ["-", "--", "-.", ":"]
        multi = len(self.points) > 1
        for li, (label, specs) in enumerate(self.spectra().items()):
            for pi, s in enumerate(specs):
                # Every curve gets a distinguishing legend entry; with one
                # probe the probe suffix is noise and is dropped.
                self.spec_ax.plot(x, s, styles[pi % 4],
                                  label=f"{label} @p{pi}" if multi else label)
        self.spec_ax.set_xlabel("Wavelength (nm)")
        self.spec_ax.set_ylabel("Intensity" + (" (calibrated)" if self.white else ""))
        self.spec_ax.legend(fontsize=8)
        self.spec_ax.grid(True, alpha=0.4)
        self.fig.canvas.draw_idle()

    def show(self):
        _pyplot().show()


def main(argv=None):
    """Launcher CLI — the call surface MATLAB users had via drag3(...)
    (drag3.m:84-255). Interactive when a GUI backend exists; ``--save``
    renders the same synchronized figure headlessly (Agg) instead.
    """
    import argparse

    from sshslie_torch.utils.io_hsi import load_cube_specs

    ap = argparse.ArgumentParser(
        description="Inspect windowed-mean spectra at (draggable) probe points."
    )
    ap.add_argument("--cube", action="append", default=[],
                    help="'Label=path.mat' or bare path; repeatable")
    ap.add_argument("--experiment", default="",
                    help="experiment name from --registry; its captures are "
                         "prepended to --cube and its wavelength range fills "
                         "unset --wave_start/--wave_end "
                         "(drag_expCustom.m + fetchExperimentData.m)")
    ap.add_argument("--registry", default="experiments.yml",
                    help="experiments YAML (see sshslie_torch/experiments.py)")
    ap.add_argument("--base_dir", default="",
                    help="prefix for the registry's capture paths")
    ap.add_argument("--wave_start", type=float, default=None)
    ap.add_argument("--wave_end", type=float, default=None)
    ap.add_argument("--point", action="append", default=[],
                    help="'x,y' initial probe; repeatable (default one at 10,10)")
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--white", default="",
                    help="'y0,y1,x0,x1' white-calibration region")
    ap.add_argument("--normalization", default="zeroOne")
    ap.add_argument("--save", default="",
                    help="write a static PNG instead of opening a window (headless)")
    ap.add_argument("--mat_key", default="")
    args = ap.parse_args(argv)
    from sshslie_torch.experiments import resolve_cli_experiment

    resolve_cli_experiment(args)

    if args.save:
        import matplotlib

        matplotlib.use("Agg")

    cubes = load_cube_specs(args.cube, mat_key=args.mat_key)

    points = [tuple(int(v) for v in p.split(",")) for p in args.point] or [(10, 10)]
    white = (tuple(int(v) for v in args.white.split(",")) if args.white else None)
    insp = SpectraInspector(
        cubes, args.wave_start, args.wave_end, points=points,
        window_size=args.window, white_region=white,
        normalization=args.normalization,
    )
    if args.save:
        insp.fig.savefig(args.save, dpi=200, bbox_inches="tight")
        print(f"Wrote {args.save}")
        return insp
    insp.show()
    return insp


if __name__ == "__main__":
    main()
