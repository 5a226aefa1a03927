"""The yardstick's arithmetic: the model's operations equal a count taken
from the port's own module shapes (forward hooks) at small sizes, the issue's
figures at the cells' sizes, the kernels' work and bounds, and the trace
reduction on a made-up trace."""

import math

import pytest
import torch

from benchmark.harness import trace, yardstick
from benchmark.harness.window import Window


def _hooked_flops(bands, h, w):
    """Operations of one forward of the port's model, from its modules' shapes."""
    from sshslie_torch.models.enhance import LowLightEnhanceNet
    from sshslie_torch.models.illum_adjust import TransformerBlock
    from sshslie_torch.models.layers import Conv2d, ConvTranspose2d, Dense

    model = LowLightEnhanceNet(input_channels=bands, conv_impl="torch")
    total = {"flops": 0.0}

    def hook(mod, inputs, out):
        x = inputs[0]
        if isinstance(mod, Conv2d):
            co, ci, k, _ = mod.weight.shape
            total["flops"] += 2.0 * k * k * ci * co * out.shape[2] * out.shape[3] * out.shape[0]
        elif isinstance(mod, ConvTranspose2d):
            ci, co, k, _ = mod.weight.shape
            total["flops"] += 2.0 * k * k * ci * co * x.shape[2] * x.shape[3] * x.shape[0]
        elif isinstance(mod, Dense):
            co, ci = mod.weight.shape
            total["flops"] += 2.0 * ci * co * x[..., 0].numel()
        elif isinstance(mod, TransformerBlock):
            s = x.shape[2] * x.shape[3]
            total["flops"] += 4.0 * x.shape[0] * mod.num_heads * s * s * mod.head_dim

    for m in model.modules():
        m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.rand(1, h, w, bands))
    return total["flops"]


@pytest.mark.parametrize("bands,h,w", [(64, 32, 32), (64, 48, 40), (12, 40, 56)])
def test_request_flops_equal_the_modules_count(bands, h, w):
    assert yardstick.request_flops(bands, h, w) == pytest.approx(_hooked_flops(bands, h, w),
                                                                 rel=1e-12)


def test_the_issues_figures():
    f = yardstick.forward_flops(64, 128, 128)
    assert f["decomposition"] / (2 * 128 * 128) == 627264
    assert f["illumination"] / (2 * 128 * 128) == 111616
    assert yardstick.forward_flops(64, 512, 512)["illumination"] / (2 * 512 * 512) == 119296
    assert yardstick.train_step_flops(64, 2, 128) == pytest.approx(268.6e9, rel=5e-4)
    assert yardstick.train_step_flops(64, 8, 128) == pytest.approx(1.074e12, rel=5e-4)
    assert yardstick.request_flops(64, 512, 512) == pytest.approx(391.4e9, rel=5e-4)


def test_kernel_work_and_bounds():
    flops, nbytes, exps = yardstick.conv9_work((1, 512, 512, 64), 4)
    assert flops == 2.0 * 512 * 512 * 81 * 64 * 64
    assert nbytes == 4 * (2 * 512 * 512 * 64 + 81 * 64 * 64) and exps == 0
    # float32 conv9 at 512^2: operations bound it, 2.596 ms.
    assert yardstick.bound_s((flops, nbytes, exps), 67e12) == pytest.approx(2.5962e-3, rel=1e-4)
    f, b, e = yardstick.wgrad_work((2, 128, 128, 64), 2)
    assert b == 2 * 2 * 2 * 128 * 128 * 64 + 4 * 81 * 64 * 64
    f, b, e = yardstick.flash_work((1, 4, 4096, 16), 2)
    # bfloat16 flash: the exponentials bound it at the bfloat16 peak.
    assert yardstick.bound_s((f, b, e), 989e12) == pytest.approx(e / yardstick.PEAK_EXP)
    launches = {("forward", torch.float32, (1, 512, 512, 64)): 2,
                ("wgrad", torch.float32, (1, 512, 512, 64)): 5}
    pct = yardstick.roofline_pct(launches, 2 * 2.5962e-3 / 0.5, yardstick.conv9_work,
                                 ("forward",))
    assert pct == pytest.approx(50.0, rel=1e-4)
    assert yardstick.roofline_pct({}, 1.0, yardstick.conv9_work, ("forward",)) is None


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_trace_reduction():
    events = [
        _x("bench.window", "user_annotation", 0, 100),
        _x("bench.step enqueue", "user_annotation", 0, 60),
        _x("aten::conv2d", "cpu_op", 10, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 2),
        _x("bench.epoch sync", "user_annotation", 60, 40),
        _x("conv_c64_f32_kernel<9>", "kernel", 5, 10),
        _x("conv_c64_f32_kernel<9>", "kernel", 12, 8),     # overlaps the first
        _x("sm90_xmma_fprop_implicit_gemm", "kernel", 40, 10),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 90, 20),   # runs past the window
        _x("bench.window", "gpu_user_annotation", 0, 100),
    ]
    t = trace.summarise(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((20 - 5 + 10 + 10) * 1e-6)
    assert t.seconds_matching(("conv_c64",)) == pytest.approx(18e-6)
    assert t.class_seconds("convolutions (cuDNN)") == pytest.approx(10e-6)
    idle = dict(t.idle)
    # gaps: [0, 5) and [20, 40) under step enqueue, [50, 90) under epoch sync
    assert idle["step enqueue / aten::conv2d"] == pytest.approx(20e-6)
    assert idle["step enqueue"] == pytest.approx(5e-6)
    assert idle["epoch sync"] == pytest.approx(40e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.breakdown()["device_ops"][0][0].startswith("Memcpy")


def test_readers_read_what_ran():
    from benchmark.harness import spec

    t = trace.summarise([_x("bench.window", "user_annotation", 0, 1000),
                         _x("conv_c64_f32_kernel<9>", "kernel", 0, 500)])
    w = Window("train", "float32", seconds=2.0, items=100, item_flops=268.6e9, trace=t,
               traced_items=2, launches={"conv9": {("forward", torch.float32,
                                                    (2, 128, 128, 64)): 2}})
    assert spec.metric_reader("mfu_pct.train")(w) == pytest.approx(
        100 * 100 * 268.6e9 / 2.0 / 67e12)
    # The traced stretch: 0.5 of 1 ms busy.
    assert spec.metric_reader("idle_pct.train")(w) == pytest.approx(50.0)
    assert spec.metric_reader("idle_pct.serve")(w) is None
    # 0.25 ms busy a step, 100 steps in 2 s: 98.75% idle.
    assert spec.metric_reader("untraced_idle_pct.train")(w) == pytest.approx(98.75)
    bound = yardstick.bound_s(yardstick.conv9_work((2, 128, 128, 64), 4), 67e12)
    assert spec.metric_reader("conv9_roofline.train")(w) == pytest.approx(
        100 * 2 * bound / 500e-6)
    assert spec.metric_reader("wgrad_roofline.train")(w) is None
    assert spec.metric_reader("cudnn_ms.train")(w) is None
    assert spec.metric_reader("flash_roofline.serve")(w) is None
    assert math.isfinite(spec.metric_reader("mfu_pct.train")(w))


def test_serving_readers_read_what_ran():
    from benchmark.harness import spec

    t = trace.summarise([_x("bench.window", "user_annotation", 0, 4000),
                         _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 1000),
                         _x("flash_fwd_kernel", "kernel", 2000, 1000)])
    w = Window("serve", "float32", seconds=2.0, items=40, item_flops=391.4e9,
               service={"requests": 40, "seconds": 0.8},
               latencies=[0.001 * (k + 1) for k in range(40)], trace=t, traced_items=2)
    assert spec.metric_reader("mfu_pct.serve")(w) == pytest.approx(
        100 * 40 * 391.4e9 / 2.0 / 67e12)
    # The traced stretch: 2 of 4 ms busy.
    assert spec.metric_reader("idle_pct.serve")(w) == pytest.approx(50.0)
    assert spec.metric_reader("idle_pct.train")(w) is None
    assert spec.metric_reader("copy_ms.serve")(w) == pytest.approx(0.5)
    assert spec.metric_reader("serve_forward_ms")(w) == pytest.approx(20.0)
    assert spec.metric_reader("mfu_pct.train")(w) is None
    # 1 to 40 ms: numpy's linear 95th percentile.
    assert spec.metric_reader("serve_p95_ms")(w) == pytest.approx(38.05)
