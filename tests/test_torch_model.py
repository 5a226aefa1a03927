"""The port's LowLightEnhanceNet against the JAX one on the CPU.

Weights come from JAX ``train.init_params`` and cross over through
``sshslie_torch.interop.jax_params_to_state_dict``; inputs are one numpy
draw for both. All four outputs (R_low, I_low, I_delta, S) are compared in
float32. Measured max|d| is ~1.2e-7 (the old transplant parity was > 60 dB);
the tolerance is 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sshslie_tpu.interop import flax_params_to_torch_state_dict
from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
from sshslie_tpu.train import init_params
from sshslie_torch.interop import jax_params_to_state_dict
from sshslie_torch.models.enhance import LowLightEnhanceNet

ATOL = 1e-5


@functools.cache
def _pair(c, use_attention=False, use_transformer=True):
    """JAX model, its params and the port's state dict; one init per variant."""
    jm = JaxNet(input_channels=c, use_attention=use_attention, use_transformer=use_transformer)
    params = init_params(jm, 0, 16)
    return jm, params, jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("c,h,w,use_attention,use_transformer,conv_impl", [
    (6, 24, 32, False, True, "auto"),     # even H/W, TransformerBlock
    (6, 19, 13, False, True, "auto"),     # odd H/W: deconv crop, non-integer resizes
    (64, 16, 24, False, True, "kernel"),  # 64 bands: the shallow conv's plain kernel path
    (64, 17, 11, False, True, "kernel"),
    (224, 16, 24, False, True, "kernel"),  # 224 bands: the wide shallow conv's plain kernel path
    (6, 20, 18, True, False, "auto"),     # SEBlock variant
    (6, 16, 16, False, False, "torch"),   # no attention block
    (6, 16, 16, False, True, "kernel"),   # 6 bands: the gate sends 'kernel' to F.conv2d
])
def test_forward_matches_jax(c, h, w, use_attention, use_transformer, conv_impl):
    jm, params, sd = _pair(c, use_attention, use_transformer)
    model = LowLightEnhanceNet(c, use_attention=use_attention, use_transformer=use_transformer,
                               conv_impl=conv_impl)
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(c + h + w).random((1, h, w, c), dtype=np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for name, a, b in zip(("R_low", "I_low", "I_delta", "S"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("use_attention,use_transformer", [(False, True), (True, False)])
def test_state_dict_keys_match_jax_export(use_attention, use_transformer):
    _, params, sd = _pair(6, use_attention, use_transformer)
    ref = flax_params_to_torch_state_dict(params)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    model = LowLightEnhanceNet(6, use_attention=use_attention, use_transformer=use_transformer)
    assert set(model.state_dict()) == set(ref)
    model.load_state_dict(ref, strict=True)


def test_seeded_weights_are_reproducible():
    a = LowLightEnhanceNet(6, generator=torch.Generator().manual_seed(5)).state_dict()
    b = LowLightEnhanceNet(6, generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_checkpoint_round_trip_and_jax_reads_it(tmp_path):
    from sshslie_tpu.interop import load_torch_checkpoint
    from sshslie_torch.interop import load_checkpoint, save_checkpoint

    _, params, sd = _pair(6)
    path = save_checkpoint(str(tmp_path / "model_epoch_latest.pth"), sd, epoch=12)
    model = LowLightEnhanceNet(6)
    assert load_checkpoint(path, model) == 12
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())
    back, epoch = load_torch_checkpoint(path)
    assert epoch == 12
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for key, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[key]), np.asarray(leaf))
