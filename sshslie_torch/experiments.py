"""Experiment and capture registry, as ``sshslie_tpu/experiments.py``: the
reference's ``fetchExperimentData.m`` (a hard-coded table from an experiment
name to its ``.mat`` captures) as a YAML file:

    # experiments.yml
    jyu_indoor_100ms:
      description: indoor JYU captures, 100 ms integration
      wave_start_nm: 414.63
      wave_end_nm: 985.05
      captures:
        - data/jyu_indoor/100ms/scene1.mat
        - data/jyu_indoor/100ms/scene2.mat

:func:`load_registry`, :func:`fetch_experiment_data` and
:func:`list_experiments`; :func:`resolve_cli_experiment` is the
``--experiment``/``--registry`` handling of the viz and inspect-spectra tools.
``python -m sshslie_torch.experiments --registry experiments.yml [NAME]``
lists the registry or prints one experiment.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml


@dataclass
class Experiment:
    name: str
    captures: List[str]
    description: str = ""
    wave_start_nm: Optional[float] = None
    wave_end_nm: Optional[float] = None
    mat_key: str = "data"
    extra: Dict = field(default_factory=dict)


class Registry:
    def __init__(self, experiments: Dict[str, Experiment], base_dir: str = ""):
        self.experiments = experiments
        self.base_dir = base_dir

    def fetch(self, name: str) -> Experiment:
        if name not in self.experiments:
            raise KeyError(
                f"unknown experiment {name!r}; known: {sorted(self.experiments)}"
            )
        exp = self.experiments[name]
        if self.base_dir:
            exp = Experiment(
                name=exp.name,
                captures=[os.path.join(self.base_dir, c) for c in exp.captures],
                description=exp.description,
                wave_start_nm=exp.wave_start_nm,
                wave_end_nm=exp.wave_end_nm,
                mat_key=exp.mat_key,
                extra=exp.extra,
            )
        return exp

    def names(self) -> List[str]:
        return sorted(self.experiments)


_KNOWN_FIELDS = {"captures", "description", "wave_start_nm", "wave_end_nm", "mat_key"}


def load_registry(yaml_path: str, base_dir: str = "") -> Registry:
    """Parse an experiments YAML into a Registry."""
    with open(yaml_path) as fh:
        raw = yaml.safe_load(fh) or {}
    if not isinstance(raw, dict):
        raise ValueError(
            f"{yaml_path}: expected a mapping of experiment name → spec, got "
            f"{type(raw).__name__}"
        )
    experiments = {}
    for name, spec in raw.items():
        if not isinstance(spec, dict) or "captures" not in spec:
            raise ValueError(f"experiment {name!r} must be a mapping with 'captures'")
        extra = {k: v for k, v in spec.items() if k not in _KNOWN_FIELDS}
        experiments[name] = Experiment(
            name=name,
            captures=list(spec["captures"]),
            description=spec.get("description", ""),
            wave_start_nm=spec.get("wave_start_nm"),
            wave_end_nm=spec.get("wave_end_nm"),
            mat_key=spec.get("mat_key", "data"),
            extra=extra,
        )
    return Registry(experiments, base_dir=base_dir)


def fetch_experiment_data(name: str, yaml_path: str, base_dir: str = "") -> Experiment:
    """One-shot convenience matching the MATLAB call shape."""
    return load_registry(yaml_path, base_dir).fetch(name)


def list_experiments(yaml_path: str) -> List[str]:
    return load_registry(yaml_path).names()


def _fill_wave_range_from_envi(args) -> None:
    """Fill unset wave_start/wave_end from the first ENVI cube spec whose
    header carries per-band wavelengths.

    Only the endpoints transfer: downstream band picking interpolates a
    uniform grid between them (select_hsi_wavelengths semantics), which is
    exact for evenly-sampled captures and an approximation otherwise."""
    from sshslie_torch.utils.io_envi import envi_wavelengths
    from sshslie_torch.utils.io_hsi import split_cube_spec

    for spec in getattr(args, "cube", None) or []:
        _, path = split_cube_spec(spec)
        if not path.lower().endswith(".hdr"):
            continue
        try:
            wl = envi_wavelengths(path)
        except (OSError, ValueError):
            continue
        if wl and len(wl) >= 2:
            if args.wave_start is None:
                args.wave_start = float(wl[0])
            if args.wave_end is None:
                args.wave_end = float(wl[-1])
            print(f"wavelength range {args.wave_start:g}-{args.wave_end:g} nm "
                  f"from {os.path.basename(path)}")
            return


def resolve_cli_experiment(args) -> None:
    """Shared ``--experiment``/``--registry`` handling for the viz and
    inspect-spectra CLIs (the MATLAB workflow was
    ``drag3(fetchExperimentData('name'))``, drag_expCustom.m): prepend the
    experiment's captures to ``args.cube`` and fill ``wave_start``,
    ``wave_end``, and ``mat_key`` where the command line left them unset.
    Mutates ``args`` in place; no-op without ``args.experiment``.
    """
    if not getattr(args, "experiment", None):
        if args.wave_start is None or args.wave_end is None:
            _fill_wave_range_from_envi(args)
        if args.wave_start is None or args.wave_end is None:
            raise SystemExit(
                "--wave_start/--wave_end are required (or provide "
                "--experiment with wave_start_nm/wave_end_nm in the "
                "registry, or an ENVI --cube whose header carries "
                "wavelengths)"
            )
        if not args.cube:
            raise SystemExit("at least one --cube is required")
        args.mat_key = args.mat_key or "data"
        return
    exp = fetch_experiment_data(
        args.experiment, args.registry, base_dir=getattr(args, "base_dir", "")
    )
    args.cube = list(exp.captures) + list(args.cube or [])
    if args.wave_start is None:
        args.wave_start = exp.wave_start_nm
    if args.wave_end is None:
        args.wave_end = exp.wave_end_nm
    if args.wave_start is None or args.wave_end is None:
        raise SystemExit(
            f"experiment {exp.name!r} declares no wave_start_nm/wave_end_nm; "
            "pass --wave_start/--wave_end explicitly"
        )
    args.mat_key = args.mat_key or exp.mat_key


def main(argv=None) -> int:
    """List a registry's experiments, or print one with its captures."""
    import argparse

    ap = argparse.ArgumentParser(description="List or show experiments of a registry.")
    ap.add_argument("name", nargs="?", default="", help="an experiment to show")
    ap.add_argument("--registry", default="experiments.yml")
    ap.add_argument("--base_dir", default="", help="prefix for the captures' paths")
    args = ap.parse_args(argv)
    if not args.name:
        for name in list_experiments(args.registry):
            print(name)
        return 0
    exp = fetch_experiment_data(args.name, args.registry, base_dir=args.base_dir)
    print(f"{exp.name}: {exp.description}")
    print(f"wavelengths: {exp.wave_start_nm} - {exp.wave_end_nm} nm, mat_key {exp.mat_key!r}")
    for c in exp.captures:
        print(f"  {c}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
