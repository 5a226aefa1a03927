"""The 224-band cell's yardstick: the wide kernels' work equals a count taken
from the port's own modules, the step's operations are the configuration's
figures, and the wide readers read only the wide kernels' launches and
names (None where none ran, as on a program without the wide entries)."""

import pytest
import torch

from benchmark.harness import trace, yardstick
from benchmark.harness.wide import wide_conv_work, wide_wgrad_work
from benchmark.harness.window import Window

CELL = (8, 128, 128, 224, 64)      # b8 x 128^2 crops, 224 bands -> 64 features


def _shallow_conv_flops(bands, b, h, w):
    """Operations of the shallow conv's forward, from the port's module shapes."""
    from sshslie_torch.models.enhance import LowLightEnhanceNet

    model = LowLightEnhanceNet(input_channels=bands, conv_impl="torch")
    conv = model.decomposition_net.shallow_conv[0]
    got = {}

    def hook(mod, inputs, out):
        co, ci, k, _ = mod.weight.shape
        got["flops"] = 2.0 * k * k * ci * co * out.shape[0] * out.shape[2] * out.shape[3]
        got["shape"] = (out.shape[0], out.shape[2], out.shape[3], ci, co)

    conv.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.rand(b, h, w, bands))
    return got


@pytest.mark.parametrize("bands,b,h,w", [(224, 1, 16, 24), (96, 2, 8, 8)])
def test_wide_work_equals_the_modules_count(bands, b, h, w):
    got = _shallow_conv_flops(bands, b, h, w)
    assert got["shape"] == (b, h, w, bands, 64)
    assert wide_conv_work(got["shape"], 4)[0] == got["flops"]
    assert wide_wgrad_work(got["shape"], 4)[0] == got["flops"]


def test_the_configurations_figures():
    assert yardstick.train_step_flops(224, 8, 128) == pytest.approx(2.669e12, rel=5e-4)
    f = yardstick.forward_flops(224, 128, 128)
    shallow = 2.0 * 81 * 224 * 64 * 128 * 128
    # The shallow conv: 68% of the step's operations, 73% of the decomposition net's.
    assert 3 * 8 * 2 * shallow / yardstick.train_step_flops(224, 8, 128) == pytest.approx(0.68,
                                                                                          abs=0.005)
    assert shallow / f["decomposition"] == pytest.approx(0.73, abs=0.005)
    # A pass at the cell's shape: 304.4 GFLOP, 4.543 ms at 67 TFLOP/s.
    work = wide_conv_work(CELL, 4)
    assert work[0] == pytest.approx(304.4e9, rel=1e-3)
    assert work[1] == 4 * (8 * 128 * 128 * (224 + 64) + 81 * 224 * 64)
    assert yardstick.bound_s(work, 67e12) == pytest.approx(4.5434e-3, rel=1e-4)
    assert wide_wgrad_work(CELL, 4)[1] == 4 * 8 * 128 * 128 * (224 + 64) + 4 * 81 * 224 * 64


def _x(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "tid": 1}


WIDE_NAMES = ("void (anonymous namespace)::wide_f32_kernel<(anonymous namespace)::F32Tile<9, 16, 4> >"
              "(float const*, float const*, float*, int, int, int, int, int, int, int)",
              "void (anonymous namespace)::wide_f32_prep_kernel<(anonymous namespace)::F32Tile<9, 16, 4> >"
              "(float const*, float const*, float*, float*, int, int, int, int, int, int)",
              # The weight gradient's: the 64-channel entry's kernels at Cin from the grid.
              "void (anonymous namespace)::wgrad_c64_kernel<9, 0>(float const*, float const*, float*, "
              "int, int, int, int)",
              "(anonymous namespace)::wgrad_reduce_kernel(float4 const*, float4*, int, int)")


def test_wide_kernel_names_are_hand_kernels_and_the_conv_stays_out_of_the_c64_readers():
    for name in WIDE_NAMES:
        assert trace.kernel_class(name) != "convolutions (cuDNN)"
    for name in WIDE_NAMES[:2]:
        assert not any(p in name for p in ("conv_c64", "wgrad_c64", "wgrad_reduce"))


def _window(launches, kernels):
    t = trace.summarise([{"ph": "X", "name": "bench.window", "cat": "user_annotation", "ts": 0,
                          "dur": 100000}] + [_x(n, ts, d) for n, ts, d in kernels])
    return Window("train", "float32", seconds=40.0, items=400, item_flops=2.669e12, trace=t,
                  traced_items=40, launches=launches)


def test_wide_readers_read_the_wide_launches():
    from benchmark.harness import spec

    f32 = torch.float32
    launches = {"conv9": {("wide_forward", f32, CELL): 2,
                          ("forward", f32, (2, 128, 128, 64)): 5},   # not the wide readers'
                "wgrad": {("wide_wgrad", f32, CELL): 2}}
    w = _window(launches, [(WIDE_NAMES[0], 0, 12000), (WIDE_NAMES[1], 12000, 1000),
                           (WIDE_NAMES[2], 20000, 15000), (WIDE_NAMES[3], 35000, 1000),
                           ("conv_c64_f32_kernel<9>", 40000, 5000)])
    fwd = 2 * yardstick.bound_s(wide_conv_work(CELL, 4), 67e12)
    assert spec.metric_reader("conv9_roofline.train_li224")(w) == pytest.approx(
        100 * fwd / 13e-3)
    wg = 2 * yardstick.bound_s(wide_wgrad_work(CELL, 4), 67e12)
    assert spec.metric_reader("wgrad_roofline.train_li224")(w) == pytest.approx(
        100 * wg / 16e-3)
    assert spec.metric_reader("mfu_pct.train_li224")(w) == pytest.approx(
        100 * 400 * 2.669e12 / 40.0 / 67e12)


def test_wide_readers_read_nothing_without_wide_launches():
    from benchmark.harness import spec

    f32 = torch.float32
    # The parent's program in this cell: the shallow conv on cuDNN, no wide launch.
    w = _window({"conv9": {}, "wgrad": {}, "flash": {}}, [("sm80_xmma_fprop_implicit_gemm", 0, 9000)])
    assert spec.metric_reader("conv9_roofline.train_li224")(w) is None
    assert spec.metric_reader("wgrad_roofline.train_li224")(w) is None
    # The 64-channel launches are not the wide readers'.
    w = _window({"conv9": {("forward", f32, (2, 128, 128, 64)): 4},
                 "wgrad": {("wgrad", f32, (2, 128, 128, 64)): 2}},
                [("conv_c64_f32_kernel<9>", 0, 5000), ("wgrad_c64_kernel<9>", 5000, 5000)])
    assert spec.metric_reader("conv9_roofline.train_li224")(w) is None
    assert spec.metric_reader("wgrad_roofline.train_li224")(w) is None
    # And the 64-channel readers read what they read before.
    assert spec.metric_reader("conv9_roofline.train")(w) == pytest.approx(
        100 * 4 * yardstick.bound_s(yardstick.conv9_work((2, 128, 128, 64), 4), 67e12) / 5e-3)
