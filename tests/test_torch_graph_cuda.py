"""The CUDA graph of the fused step (``train._StepGraph``) on the card.

Every test here needs a CUDA card and nvcc, carries the ``cuda`` marker and
skips without one. The file imports only torch, numpy, scipy and the port,
so it runs on a machine without JAX:

    python -m pytest tests/test_torch_graph_cuda.py -q --noconftest

* Over six steps of one model, with the rate and the draws changing between
  replays, the steps of ``multistep_train_step`` (the first eager, the
  second captured, the rest replayed) equal eager ``fused_train_step`` steps
  bit for bit where two eager runs are bit for bit (cuDNN deterministic),
  else within the float32 cell's limits (step 1's loss 1e-5, every step's
  1e-2, each leaf's change over the six steps 0.2 of its norm): float32,
  bfloat16, remat, the freeze mask, and the flash kernel in the forward.
* A new Adam, a new cube storage or Adam's ``load_state_dict`` captures
  anew; the same key replays.
* The kernels' launch counts after k graphed steps equal k eager steps'.
* Replays traced by ``torch.profiler`` show the graph's kernels by name
  (``conv_c64``, ``wgrad_c64``), which the benchmark's rooflines read, and a
  capture while a profiler records (``profile_dir``'s first epoch) works.
* ``Trainer.fit`` on the card: 3 epochs straight equal 2 and 1 resumed from
  the checkpoint (its Adam made capturable again, then graphed; the rate
  changes at the resumed epoch), bit for bit where two straight runs are,
  else the last epoch's terms within 1e-2.
"""


import numpy as np
import pytest
import scipy.io as sio
import torch

from sshslie_torch.config import load_config
from sshslie_torch.data.datasets import CubeStore
from sshslie_torch.models.enhance import build_model
from sshslie_torch.ops import attention, conv9
from sshslie_torch.train import (LOSS_KEYS, Trainer, fused_draws, fused_train_step,
                                 loss_coeffs, make_optimizer, multistep_train_step, set_lr)

BANDS, B, P, N, HW = 64, 2, 64, 4, 80
RATES = (1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4, 1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _cfg(**kw):
    return load_config(None, dict(dict(channels=BANDS, patch_size=P, batch_size=B,
                                       seed_value=41, device="cuda"), **kw), finalize=False)


def _inputs(dev, steps=6):
    rng = np.random.default_rng(7)
    cubes = torch.from_numpy(rng.random((N, HW, HW, BANDS), dtype=np.float32)).to(dev)
    draws = torch.from_numpy(fused_draws(41, 0, steps, B, (HW, HW), P)).to(dev)
    return cubes, draws


def _run(cfg, state, dev, graphed, freeze=False):
    """Six steps from ``state`` at RATES → (each step's 7 terms, the weights)."""
    model = build_model(cfg, BANDS, dev, train=True)
    model.load_state_dict(state)
    opt = make_optimizer(model, RATES[0])
    cubes, draws = _inputs(dev)
    coeffs = loss_coeffs(cfg)
    terms = []
    for i, lr in enumerate(RATES):
        set_lr(opt, lr)
        if graphed:
            t = multistep_train_step(model, opt, cubes, draws, [i], B, P, coeffs, freeze)
        else:
            t = fused_train_step(model, opt, cubes, draws[i], i * B, P, coeffs, freeze)
        terms.append(torch.stack([t[k] for k in LOSS_KEYS]))
    return torch.stack(terms).cpu(), {k: v.detach().cpu().clone()
                                      for k, v in model.state_dict().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kw,freeze", [
    ({}, False), ({"precision": "bfloat16"}, False), ({"remat": True}, False), ({}, True),
    ({"attention_impl": "kernel"}, False),
], ids=["float32", "bfloat16", "remat", "freeze", "flash"])
def test_replayed_steps_equal_eager_steps(card, kw, freeze):
    cfg = _cfg(**kw)
    state = {k: v.clone() for k, v in build_model(cfg, BANDS, card, train=True).state_dict().items()}
    eager = _run(cfg, state, card, graphed=False, freeze=freeze)
    again = _run(cfg, state, card, graphed=False, freeze=freeze)
    captures, replays = multistep_train_step.graph_captures, multistep_train_step.graph_replays
    graphed = _run(cfg, state, card, graphed=True, freeze=freeze)
    assert multistep_train_step.graph_captures == captures + 1
    assert multistep_train_step.graph_replays == replays + 5
    exact = torch.equal(eager[0], again[0]) and all(torch.equal(eager[1][k], again[1][k])
                                                     for k in eager[1])
    if exact:
        assert torch.equal(graphed[0], eager[0])
        for k in eager[1]:
            assert torch.equal(graphed[1][k], eager[1][k]), k
        return
    rel = ((graphed[0] - eager[0]).abs() / eager[0].abs().clamp_min(1e-30))[:, 0]
    assert float(rel[0]) <= 1e-5 and float(rel.max()) <= 1e-2, rel
    for k in eager[1]:
        change = (eager[1][k] - state[k].cpu()).norm()
        if float(change) > 0:
            gap = abs(float((graphed[1][k] - state[k].cpu()).norm()) - float(change))
            assert gap <= 0.2 * float(change), k


@pytest.mark.cuda
def test_a_new_key_captures_anew(card):
    cfg = _cfg()
    model = build_model(cfg, BANDS, card, train=True)
    cubes, draws = _inputs(card)
    coeffs = loss_coeffs(cfg)

    def captures_in(opt, cubes, ids):
        before = multistep_train_step.graph_captures
        terms = multistep_train_step(model, opt, cubes, draws, ids, B, P, coeffs)
        assert all(bool(torch.isfinite(v)) for v in terms.values())
        return multistep_train_step.graph_captures - before

    opt = make_optimizer(model, 1e-3)
    assert captures_in(opt, cubes, [0, 1, 2]) == 1
    assert captures_in(opt, cubes, [3, 4]) == 0
    opt = make_optimizer(model, 1e-3)                 # Trainer's new Adam at unfreeze
    assert captures_in(opt, cubes, [0, 1, 2]) == 1
    cubes = cubes.clone()                             # a new window's storage
    assert captures_in(opt, cubes, [3, 4]) == 1
    opt.load_state_dict(opt.state_dict())             # new state tensors
    assert captures_in(opt, cubes, [5, 0]) == 1
    assert captures_in(opt, cubes, [1]) == 0


def _counts():
    return {"conv9": dict(conv9.conv9_fwd.launches_by_shape),
            "wgrad": dict(conv9.conv9_wgrad.launches_by_shape),
            "flash": dict(attention.flash_attention.launches_by_shape)}


@pytest.mark.cuda
def test_launch_counts_of_graphed_steps_equal_eager_steps(card):
    cfg = _cfg(attention_impl="kernel")
    model = build_model(cfg, BANDS, card, train=True)
    cubes, draws = _inputs(card)
    coeffs = loss_coeffs(cfg)
    conv9.reset_counts()
    attention.reset_counts()
    fused_train_step(model, make_optimizer(model, 1e-3), cubes, draws[0], 0, P, coeffs)
    one = _counts()
    assert one["conv9"] and one["wgrad"] and one["flash"]
    opt = make_optimizer(model, 1e-3)
    for ids in (range(4), range(4, 6)):
        conv9.reset_counts()
        attention.reset_counts()
        multistep_train_step(model, opt, cubes, draws, ids, B, P, coeffs)
        torch.cuda.synchronize()
        got = _counts()
        for name, shapes in one.items():
            assert got[name] == {key: n * len(ids) for key, n in shapes.items()}, name
    conv9.reset_counts()
    attention.reset_counts()


def _device_names(prof) -> set:
    return {e.key for e in prof.key_averages()
            if (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)) > 0}


@pytest.mark.cuda
def test_replays_show_their_kernels_in_a_trace(card):
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    model = build_model(cfg, BANDS, card, train=True)
    cubes, draws = _inputs(card)
    coeffs = loss_coeffs(cfg)
    opt = make_optimizer(model, 1e-3)
    multistep_train_step(model, opt, cubes, draws, [0, 1], B, P, coeffs)   # eager, captured
    torch.cuda.synchronize()
    replays = multistep_train_step.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        multistep_train_step(model, opt, cubes, draws, [2, 3], B, P, coeffs)
        torch.cuda.synchronize()
    assert multistep_train_step.graph_replays == replays + 2
    names = _device_names(prof)
    assert any("conv_c64" in n for n in names) and any("wgrad_c64" in n for n in names), names
    # A capture while the profiler records.
    opt = make_optimizer(model, 1e-3)
    captures = multistep_train_step.graph_captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        terms = multistep_train_step(model, opt, cubes, draws, [0, 1, 2], B, P, coeffs)
        torch.cuda.synchronize()
    assert multistep_train_step.graph_captures == captures + 1
    assert all(bool(torch.isfinite(v)) for v in terms.values())
    assert any("conv_c64" in n for n in _device_names(prof))


@pytest.mark.cuda
def test_trainer_resume_on_the_card_equals_the_uninterrupted_run(card, tmp_path):
    rng = np.random.RandomState(20260816)
    data = tmp_path / "cubes"
    data.mkdir()
    for i in range(N):
        sio.savemat(str(data / f"c{i}.mat"),
                    {"data": (rng.rand(HW, HW, BANDS) * 100).astype(np.float32)})
    kw = dict(channels=BANDS, patch_size=P, batch_size=B, eval_every_epoch=100,
              plot_every_epoch=100, seed_value=41, device="cuda", steps_per_dispatch=2,
              lr_update_period=2)
    runs = {}
    for name, epochs in (("straight", [3]), ("again", [3]), ("resumed", [2, 3])):
        ckpt = str(tmp_path / name)
        for i, epoch in enumerate(epochs):
            trainer = Trainer(load_config(None, dict(kw, epoch=epoch, resume=i > 0)), BANDS)
            trainer.fit(CubeStore(str(data), normalization="self"), ckpt_dir=ckpt)
        group = trainer.optimizer.param_groups[0]
        assert group["capturable"] and isinstance(group["lr"], torch.Tensor)
        runs[name] = (np.array([trainer.all_epoch_losses[k][-1] for k in LOSS_KEYS]),
                      {k: v.cpu() for k, v in trainer.model.state_dict().items()})
    (loss, weights), resumed = runs["straight"], runs["resumed"]
    if np.array_equal(loss, runs["again"][0]) and all(
            torch.equal(weights[k], runs["again"][1][k]) for k in weights):
        np.testing.assert_array_equal(resumed[0], loss)
        for k in weights:
            assert torch.equal(resumed[1][k], weights[k]), k
    else:
        np.testing.assert_allclose(resumed[0], loss, rtol=1e-2)
