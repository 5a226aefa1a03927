"""Shared fixtures of the benchmark's CPU tests: the checkout root on the
path, the card marker, and cells cut to a size a CPU test holds (the cell's
configuration and limits, tiny traffic)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Each kind of traffic cut to a CPU test's size; the mix's other keys
# (steps_per_dispatch) are kept.
TINY = {
    "train_fused": {"batch_size": 2, "patch_size": 32, "cubes": 6, "cube_hw": [64, 64]},
    "serve_u16_closed": {"pool": 2, "cube_hw": [64, 64], "checked": 2, "checked_from": 4},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_cell(tmp_path):
    """name -> the cell of BENCHMARK.json with its traffic cut to TINY."""
    from benchmark.harness import spec

    os.makedirs(tmp_path / "traffic", exist_ok=True)
    for w in spec.load_spec(ROOT)["workloads"]:
        with open(os.path.join(spec.BENCH_DIR, "traffic", w["traffic"] + ".json")) as fh:
            t = json.load(fh)
        with open(tmp_path / "traffic" / f"{w['traffic']}.json", "w") as fh:
            json.dump({**t, **TINY[t["kind"]]}, fh)

    def make(name):
        return spec.load_cell(ROOT, name, bench_dir=str(tmp_path))

    return make
