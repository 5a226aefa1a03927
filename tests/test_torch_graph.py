"""What the CUDA graph of the fused step rests on, on the CPU.

* ``sample_fused_batch`` with a 0-d tensor ``batch_start`` (a graph's input)
  equals the int form bit for bit, across the wrap of the cube index.
* ``set_lr`` fills a tensor rate in place (the object a graph reads) and
  sets a number; ``make_optimizer`` on the CPU keeps the plain Adam;
  ``capturable_adam`` leaves CPU groups as they are.
* The launch counting across a capture (``ops/launch_capture.py``), driven
  without a card: launches on a capturing stream inside ``capturing()`` are
  recorded and not counted, each ``replayed`` counts them once, launches
  outside a capture or on a stream that is not capturing count as issued.
* ``multistep_train_step``'s sums are tensors of their own: overwriting a
  step's outputs after the call (as a graph's next replay does) leaves them.
* The CPU and a mesh never graph: no graph is made, none is captured or
  replayed, and the CPU steps equal single fused steps bit for bit.
* A checkpoint of a capturable Adam (its rate a tensor) holds a plain group,
  which a CPU Adam loads.

Tiny shapes (6 bands, four 20x22 cubes, b2, 16^2 patches), one intra-op
thread; the card's side is ``tests/test_torch_graph_cuda.py``.
"""

import os
import types

import numpy as np
import pytest
import torch

from sshslie_torch import interop
from sshslie_torch.config import load_config
from sshslie_torch.ops import attention, conv9, launch_capture
from sshslie_torch.train import (LOSS_KEYS, Trainer, _GRAPHS, _step_graph, capturable_adam,
                                 fused_draws, fused_train_step, make_optimizer,
                                 multistep_train_step, sample_fused_batch, set_lr)

COEFFS = {
    "c_loss_reconstruction": 10.0, "c_loss_r_fidelity": 1.0, "c_loss_i_smooth_low": 1.0,
    "c_loss_i_smooth_delta": 2000.0, "c_loss_fourier": 20.0, "c_loss_spectral_cons": 1.0,
    "alpha_i_smooth_low": 1.0, "alpha_i_smooth_delta": 10.0,
}
KW = dict(channels=6, patch_size=16, batch_size=2, epoch=1, eval_every_epoch=100,
          plot_every_epoch=100, attention_impl="dense", seed_value=41, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _cubes(n=4, h=20, w=22, c=6):
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.random((n, h, w, c), dtype=np.float32))


@pytest.mark.parametrize("start", [0, 2, 3, 6])
def test_tensor_batch_start_equals_int(start):
    cubes = _cubes()
    draws = torch.from_numpy(fused_draws(41, 0, 1, 3, (20, 22), 16))[0]
    want = sample_fused_batch(cubes, draws, start, 16)
    got = sample_fused_batch(cubes, draws, torch.tensor(start, dtype=torch.int64), 16)
    assert torch.equal(got, want)


def test_set_lr_fills_a_tensor_rate_and_sets_a_number():
    p = torch.nn.Parameter(torch.zeros(3))
    rate = torch.tensor(1e-3)
    tensor_opt = torch.optim.Adam([p], lr=rate, foreach=False)
    set_lr(tensor_opt, 2.5e-4)
    assert tensor_opt.param_groups[0]["lr"] is rate
    assert float(rate) == pytest.approx(2.5e-4)
    plain = torch.optim.Adam([torch.nn.Parameter(torch.zeros(3))], lr=1e-3)
    set_lr(plain, 2.5e-4)
    assert plain.param_groups[0]["lr"] == 2.5e-4


def test_cpu_adam_stays_plain():
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(model, 1e-3)
    group = opt.param_groups[0]
    assert group["lr"] == 1e-3 and not group["capturable"]
    assert capturable_adam(opt) is opt and group["lr"] == 1e-3 and not group["capturable"]


def test_captured_launches_count_once_a_replay(monkeypatch):
    conv9.reset_counts()
    attention.reset_counts()
    fwd = ("forward", torch.bfloat16, (8, 128, 128, 64))
    wgrad = ("wgrad", torch.bfloat16, (8, 128, 128, 64))
    flash = ("forward", torch.bfloat16, (8, 4, 256, 16))

    def one_step():
        conv9._count(conv9.conv9_fwd, torch.bfloat16, fwd)
        conv9._count(conv9.conv9_fwd, torch.bfloat16, fwd)
        conv9._count(conv9.conv9_wgrad, torch.bfloat16, wgrad)
        attention._count(torch.bfloat16, flash)

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with launch_capture.capturing() as launches:
        one_step()
    assert len(launches) == 4
    assert conv9.conv9_fwd.launches == conv9.conv9_wgrad.launches == 0
    assert attention.flash_attention.launches == 0
    for _ in range(3):
        launch_capture.replayed(launches)
    assert conv9.conv9_fwd.launches_by_shape == {fwd: 6}
    assert conv9.conv9_fwd.launches == 6 and conv9.conv9_fwd.launches_by_dtype[torch.bfloat16] == 6
    assert conv9.conv9_wgrad.launches_by_shape == {wgrad: 3}
    assert attention.flash_attention.launches_by_shape == {flash: 3}
    # Outside a capture, and inside one on a stream that is not capturing
    # (another thread's), a launch counts as it is issued.
    one_step()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with launch_capture.capturing() as other:
        one_step()
    assert other == []
    assert conv9.conv9_fwd.launches_by_shape == {fwd: 10}
    assert attention.flash_attention.launches_by_shape == {flash: 5}
    conv9.reset_counts()
    attention.reset_counts()


def test_multistep_sums_are_not_a_steps_outputs(monkeypatch):
    from sshslie_torch import train

    cfg = load_config(None, KW)
    trainer = Trainer(cfg, 6)
    cubes = _cubes()
    draws = torch.from_numpy(fused_draws(41, 0, 2, 2, (20, 22), 16))
    outputs = []

    def recording_step(*args, **kwargs):
        terms = fused_train_step(*args, **kwargs)
        outputs.append(terms)
        return terms

    monkeypatch.setattr(train, "fused_train_step", recording_step)
    for ids in ([0], [0, 1]):
        sums = multistep_train_step(trainer.model, trainer.optimizer, cubes, draws, ids, 2, 16,
                                    COEFFS)
        kept = {k: v.clone() for k, v in sums.items()}
        for terms in outputs:
            for v in terms.values():
                v.fill_(float("nan"))       # what a graph's next replay does to its outputs
        for k in LOSS_KEYS:
            assert torch.equal(sums[k], kept[k]) and torch.isfinite(sums[k]), k
        outputs.clear()


def test_cpu_and_mesh_do_not_graph():
    cfg = load_config(None, KW)
    cubes = _cubes()
    draws = torch.from_numpy(fused_draws(41, 0, 2, 2, (20, 22), 16))
    runs = []
    before = (multistep_train_step.graph_captures, multistep_train_step.graph_replays)
    for chunked in (False, True):
        trainer = Trainer(cfg, 6)
        if chunked:
            sums = multistep_train_step(trainer.model, trainer.optimizer, cubes, draws, [0, 1],
                                        2, 16, COEFFS)
            assert trainer.optimizer not in _GRAPHS
        else:
            t0, t1 = (fused_train_step(trainer.model, trainer.optimizer, cubes, draws[i], 2 * i,
                                       16, COEFFS) for i in range(2))
            sums = {k: t0[k] + t1[k] for k in LOSS_KEYS}
        runs.append((trainer.model.state_dict(), sums))
    assert (multistep_train_step.graph_captures, multistep_train_step.graph_replays) == before
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    for k in LOSS_KEYS:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    # A mesh steps eagerly whatever the device: no graph is looked up.
    card_cubes = types.SimpleNamespace(device=torch.device("cuda"))
    assert _step_graph(trainer.model, trainer.optimizer, card_cubes, 2, 16, COEFFS, False,
                       mesh=object()) is None
    assert trainer.optimizer not in _GRAPHS


def test_checkpoint_of_a_capturable_adam_holds_a_plain_group(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=torch.tensor(2.5e-4), foreach=False)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    state = opt.state_dict()
    state["param_groups"][0]["capturable"] = True     # as capturable_adam leaves it on a card
    path = interop.save_checkpoint(os.path.join(tmp_path, "m.pth"), model.state_dict(), 1, state)
    saved = torch.load(path, weights_only=True)["optimizer_state_dict"]["param_groups"][0]
    assert saved["lr"] == pytest.approx(2.5e-4) and isinstance(saved["lr"], float)
    assert saved["capturable"] is False
    fresh = torch.nn.Linear(3, 2)
    cpu_opt = make_optimizer(fresh, 1e-3)
    assert interop.load_checkpoint(path, fresh, cpu_opt) == 1
    fresh(torch.ones(1, 3)).sum().backward()
    cpu_opt.step()        # a CPU Adam steps on the loaded state
    assert float(cpu_opt.state[fresh.weight]["step"]) == 2
    assert isinstance(cpu_opt.param_groups[0]["lr"], float)
