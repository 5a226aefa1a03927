"""The comparison that decides ``correct`` fails what it must, at a size a
CPU test holds: a run driven past the card check with the timed path broken
underneath reads ``correct`` false, once for each fault a cell can have (a
training step that leaves its state unchanged; half of each batch left out,
the mean taken over the rest; a served answer altered where it is made:
its bands in reverse order),
and the control (the reference one precision below the configuration's, in
the program's place) fails the cell's limits. The same seed's sound run
reads a tenth of the fault's number or less."""

import time

import pytest
import torch

from benchmark.harness import compare, spec
from conftest import ROOT

SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in spec.load_spec(ROOT)["workloads"]]


def _work(name):
    return spec.driver(spec.load_cell(ROOT, name).traffic["kind"]).WORK


TRAIN = [c for c in CELLS if _work(c) == "train"]
SERVE = [c for c in CELLS if _work(c) == "serve"]


def _run(cell):
    from benchmark import run

    return run.execute(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                       compare.load_limits(cell.name))


def _worst_ratio(fault, sound):
    return max(fault[k]["value"] / max(sound[k]["value"], 1e-30) for k in fault)


@pytest.fixture
def unchanged_state(monkeypatch):
    import sshslie_torch.train as port_train

    monkeypatch.setattr(port_train, "_update", lambda model, optimizer, freeze: None)


@pytest.fixture
def half_batch(monkeypatch):
    import sshslie_torch.train as port_train

    sample = port_train.sample_fused_batch

    def first_half(cubes, draws, batch_start, patch_size):
        return sample(cubes, draws[: max(draws.shape[0] // 2, 1)], batch_start, patch_size)

    monkeypatch.setattr(port_train, "sample_fused_batch", first_half)


@pytest.fixture
def altered_answer(monkeypatch):
    from sshslie_torch.evaluate import Inferencer

    call = Inferencer.__call__

    def altered(self, weights, cube):
        R, I, Id, S = call(self, weights, cube)
        return R, I, Id, S.flip(-1)

    monkeypatch.setattr(Inferencer, "__call__", altered)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_fail(tiny_cell, request, name, fault):
    sound = _run(tiny_cell(name))
    request.getfixturevalue(fault)
    broken = _run(tiny_cell(name))
    assert broken["correct"] is False
    assert _worst_ratio(broken["checks"], sound["checks"]) >= 10


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_fails(tiny_cell, request, name):
    sound = _run(tiny_cell(name))
    request.getfixturevalue("altered_answer")
    broken = _run(tiny_cell(name))
    assert broken["correct"] is False
    assert _worst_ratio(broken["checks"], sound["checks"]) >= 10


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fails(tiny_cell, name):
    from benchmark.reference import train as rt

    cell = tiny_cell(name)
    td = spec.driver(cell.traffic["kind"])
    s = td.setup(cell, SEED, torch.device("cpu"))
    rounding = cell.config["control_rounding"]

    def control(coeffs, lr):
        terms, g1, p3 = rt.train(s.params0, s.cubes, s.cfg.channels, SEED, s.cfg.batch_size,
                                 s.cfg.patch_size, coeffs, lr, td.CHECKED_STEPS, rnd=rounding)
        return terms, g1, p3

    checks = compare.judge(td.check(s, control), compare.load_limits(name))
    assert not compare.passed(checks)


@pytest.mark.parametrize("name", SERVE)
def test_serving_control_fails(tiny_cell, name):
    cell = tiny_cell(name)
    sd = spec.driver(cell.traffic["kind"])
    s = sd.setup(cell, SEED, torch.device("cpu"))
    sd.window(s, 0.3, False)
    sd.release(s)
    checks = compare.judge(sd.check(s, cell.config["control_rounding"]),
                           compare.load_limits(name))
    assert not compare.passed(checks)
