"""The port's command-line tools against the JAX package's on the CPU.

Their arrays are numpy and scipy in both packages, so they are held exactly:

* experiments: the registry, ``fetch_experiment_data``,
  ``resolve_cli_experiment`` (the experiment's captures and wavelengths, the
  ENVI header's wavelengths, the errors), and ``main``.
* viz: each function's arrays (the stretches, band picking, display
  params, every normalisation of ``false_color``, ``true_color``,
  ``windowed_spectrum``); the figures and ``main`` where matplotlib imports.
* inspect_spectra: ``probe_spectra`` and ``white_reference`` against the JAX
  inspector's ``spectra()``, and ``main --save``.
* align: shifts, warps, edge proxies, the flow and its residuals, and the
  batch checker's CSV bytes and aligned cube, on .mat and ENVI pairs.
* doctor: every row but the environment's equals the JAX doctor's for the
  same config and dataset (the checkpoint file name ``.pth`` for ``.ckpt``),
  and the FAIL cases exit with 1.
* serve_client: the request it sends (path, headers, body) equals the JAX
  client's for the same cube in each wire encoding, and one round trip
  through the port's server returns the service's own S.
"""

import argparse
import csv
import http.server
import importlib.util
import os
import threading

import numpy as np
import pytest
import scipy.io as sio
import scipy.ndimage as ndi

from sshslie_tpu import align as jalign
from sshslie_tpu import experiments as jexp
from sshslie_tpu import viz as jviz
from sshslie_torch import align, experiments, inspect_spectra, viz
from sshslie_torch.utils.io_envi import save_envi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAVE_MPL = importlib.util.find_spec("matplotlib") is not None


def _scene(rng, h=64, w=64):
    img = ndi.gaussian_filter(rng.rand(h, w), 3)
    img[20:30, 15:40] += 1.0
    img[40:50, 30:35] += 0.8
    return ndi.gaussian_filter(img, 1)


def _cube(seed, h=24, w=24, c=6):
    return (np.random.default_rng(seed).random((h, w, c)) * 1000).astype(np.float32)


# ---- experiments ----

REGISTRY = """
indoor:
  description: two captures
  wave_start_nm: 414.63
  wave_end_nm: 985.05
  mat_key: cube
  captures: [a.mat, sub/b.mat]
  exposure_ms: 100
bare:
  captures: [c.mat]
"""


def _args(**kw):
    base = dict(experiment="", registry="", base_dir="", cube=[], wave_start=None,
                wave_end=None, mat_key="")
    return argparse.Namespace(**{**base, **kw})


def test_registry_equals_jax(tmp_path, capsys):
    path = tmp_path / "experiments.yml"
    path.write_text(REGISTRY)
    ours = experiments.fetch_experiment_data("indoor", str(path), base_dir="/data")
    theirs = jexp.fetch_experiment_data("indoor", str(path), base_dir="/data")
    assert vars(ours) == vars(theirs)
    assert ours.captures == ["/data/a.mat", "/data/sub/b.mat"] and ours.extra == {"exposure_ms": 100}
    assert experiments.list_experiments(str(path)) == jexp.list_experiments(str(path))
    with pytest.raises(KeyError, match="unknown experiment 'nope'"):
        experiments.load_registry(str(path)).fetch("nope")
    (tmp_path / "bad.yml").write_text("x: {description: no captures}\n")
    with pytest.raises(ValueError, match="must be a mapping with 'captures'"):
        experiments.load_registry(str(tmp_path / "bad.yml"))
    assert experiments.main(["--registry", str(path)]) == 0
    assert experiments.main(["indoor", "--registry", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("bare\nindoor\n") and "  a.mat" in out


def test_resolve_cli_experiment_equals_jax(tmp_path):
    path = str(tmp_path / "experiments.yml")
    open(path, "w").write(REGISTRY)
    hdr, _ = save_envi(str(tmp_path / "cap"), _cube(1), wavelengths=[450, 500, 550, 600, 650, 700])
    bare, _ = save_envi(str(tmp_path / "bare"), _cube(2, c=3))
    cases = [dict(experiment="indoor", registry=path, cube=["x.mat"]),
             dict(experiment="indoor", registry=path, wave_start=500.0, mat_key="data"),
             dict(cube=[f"L={hdr}"]),
             dict(cube=["a.mat"], wave_start=1.0, wave_end=2.0)]
    for kw in cases:
        ours, theirs = _args(**kw), _args(**kw)
        experiments.resolve_cli_experiment(ours)
        jexp.resolve_cli_experiment(theirs)
        assert vars(ours) == vars(theirs), kw
    for kw, match in ((dict(experiment="bare", registry=path), "declares no wave_start_nm"),
                      (dict(cube=[bare]), "wave_start/--wave_end are required"),
                      (dict(wave_start=1.0, wave_end=2.0), "at least one --cube")):
        for mod in (experiments, jexp):
            with pytest.raises(SystemExit, match=match):
                mod.resolve_cli_experiment(_args(**kw))


# ---- viz ----

@pytest.mark.parametrize("normalization,kw", [
    ("none", {}), ("zeroOne", {}), ("divideMax", {}), ("divideGlobalMax", {"global_max": 900.0}),
    ("percClip", {}), ("zeroOne", {"gamma": 2.2}), ("shared", {}),
])
def test_false_color_equals_jax(normalization, kw):
    cube = _cube(3, 20, 18, 16).astype(np.float64)
    args = (cube, 414.63, 985.05)
    if normalization == "shared":
        idx = viz.band_indices_for_wavelengths(16, 414.63, 985.05, viz.FALSE_COLOR_JYU)
        assert idx == jviz.band_indices_for_wavelengths(16, 414.63, 985.05, jviz.FALSE_COLOR_JYU)
        others = [cube, cube[:15] * 1.5]
        for method in ("fixedMax", "percentile"):
            dp = viz.compute_display_params(others, idx, method=method, pct=97.0, gamma=1.8)
            jdp = jviz.compute_display_params(others, idx, method=method, pct=97.0, gamma=1.8)
            np.testing.assert_array_equal(dp.channel_min, jdp.channel_min)
            np.testing.assert_array_equal(dp.channel_max, jdp.channel_max)
        kw = {"display_params": dp, "targets_nm": viz.FALSE_COLOR_JYU}
        jkw = {"display_params": jdp, "targets_nm": jviz.FALSE_COLOR_JYU}
    else:
        jkw = kw
    got = viz.false_color(*args, normalization=normalization, **kw)
    np.testing.assert_array_equal(got, jviz.false_color(*args, normalization=normalization, **jkw))
    assert got.shape == (20, 18, 3)


def test_viz_arrays_equal_jax():
    cube = _cube(4, 17, 23, 12).astype(np.float64)
    np.testing.assert_array_equal(viz.true_color(cube, 400, 1000),
                                  jviz.true_color(cube, 400, 1000))
    np.testing.assert_array_equal(viz.pct_stretch(cube[..., 0], 5, 95),
                                  jviz.pct_stretch(cube[..., 0], 5, 95))
    np.testing.assert_array_equal(viz.pct_stretch(np.ones((3, 3))), jviz.pct_stretch(np.ones((3, 3))))
    np.testing.assert_array_equal(viz.min_max_stretch(cube), jviz.min_max_stretch(cube))
    for x, y, win in ((0, 0, 5), (10, 7, 3), (22, 16, 5), (5, 5, 1)):
        np.testing.assert_array_equal(viz.windowed_spectrum(cube, x, y, win),
                                      jviz.windowed_spectrum(cube, x, y, win))
    assert [viz._point_label(i) for i in (0, 25, 26, 53)] == ["a", "z", "a1", "b2"]
    for bad in (lambda m: m.false_color(cube, 400, 1000, normalization="divideGlobalMax"),
                lambda m: m.false_color(cube, 400, 1000, normalization="shared"),
                lambda m: m.false_color(cube, 400, 1000, normalization="nope"),
                lambda m: m.compute_display_params([cube], [0, 1, 2], method="nope")):
        for mod in (viz, jviz):
            with pytest.raises(ValueError):
                bad(mod)


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib is not installed")
def test_viz_figures_and_main(tmp_path):
    cube = _cube(5, 32, 32, 8).astype(np.float64)
    rgb = viz.false_color(cube, 400, 1000)
    assert os.path.exists(viz.save_false_color_figure(rgb, str(tmp_path / "f.png"),
                                                      points=[(3, 4)], title="t", dpi=50))
    paths = viz.plot_spectra_at_points({"a": cube, "b": cube * 2}, [(3, 4), (10, 12)],
                                       str(tmp_path / "spec"))
    assert [os.path.basename(p) for p in paths] == ["spectrum_at_a.png", "spectrum_at_b.png"]
    assert os.path.exists(viz.comparison_grid({"a": rgb, "g": cube[..., 0]},
                                              str(tmp_path / "g.png"), dpi=50))
    sio.savemat(str(tmp_path / "a.mat"), {"data": cube.astype(np.float32)})
    hdr, _ = save_envi(str(tmp_path / "b"), cube.astype(np.float32),
                       wavelengths=list(np.linspace(400, 1000, 8)))
    written = viz.main(["--cube", f"A={tmp_path / 'a.mat'}", "--cube", hdr, "--out",
                        str(tmp_path / "out"), "--normalization", "shared"])
    assert sorted(os.path.basename(p) for p in written) == ["A.png", "b.png"]
    assert viz.main(["--cube", str(tmp_path / "a.mat"), "--cube", hdr, "--out",
                     str(tmp_path / "grid"), "--grid"]) == [str(tmp_path / "grid" / "grid.png")]


# ---- inspect_spectra ----

@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib is not installed")
def test_inspect_spectra_equal_jax(tmp_path):
    from sshslie_tpu.inspect_spectra import SpectraInspector as JaxInspector

    cubes = {"a": _cube(6).astype(np.float64), "b": _cube(7).astype(np.float64)}
    points = [(3, 4), (20, 10)]
    for region in (None, (0, 5, 0, 5)):
        white = None if region is None else inspect_spectra.white_reference(cubes, region)
        got = inspect_spectra.probe_spectra(cubes, points, 3, white)
        want = JaxInspector(cubes, 400, 1000, points=points, window_size=3,
                            white_region=region).spectra()
        assert list(got) == list(want)
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)
        insp = inspect_spectra.SpectraInspector(cubes, 400, 1000, points=points, window_size=3,
                                                white_region=region)
        for k in want:
            for g, w in zip(insp.spectra()[k], want[k]):
                np.testing.assert_array_equal(g, w)
    sio.savemat(str(tmp_path / "a.mat"), {"data": cubes["a"].astype(np.float32)})
    out = str(tmp_path / "probe.png")
    inspect_spectra.main(["--cube", f"GT={tmp_path / 'a.mat'}", "--wave_start", "400",
                          "--wave_end", "1000", "--point", "5,6", "--save", out])
    assert os.path.exists(out)
    with pytest.raises(ValueError, match="one band count"):
        inspect_spectra.SpectraInspector({"a": cubes["a"], "c": _cube(8, c=3)}, 400, 1000)


# ---- align ----

def test_align_primitives_equal_jax():
    rng = np.random.RandomState(1234)
    fixed = _scene(rng, 96, 96)
    cube = np.stack([fixed * (1 + 0.1 * b) for b in range(6)], axis=-1) + rng.rand(96, 96, 6) * 0.01
    for method in ("band", "mean", "median", "pca"):
        np.testing.assert_array_equal(align.project_2d(cube, method, 3),
                                      jalign.project_2d(cube, method, 3))
    for dy, dx in ((3, 0), (-2, 5), (0.6, -0.4)):
        moving = ndi.shift(fixed, (dy, dx), order=3, mode="nearest")
        assert align.phase_correlation_shift(moving, fixed) == jalign.phase_correlation_shift(moving, fixed)
        np.testing.assert_array_equal(align.warp_translate(moving, -dy, -dx),
                                      jalign.warp_translate(moving, -dy, -dx))
        for got, want in zip(align.lucas_kanade_flow(fixed, moving),
                             jalign.lucas_kanade_flow(fixed, moving)):
            np.testing.assert_array_equal(got, want)
        for method in ("lk", "proxy"):
            assert align.residual_motion(moving, fixed, method) == jalign.residual_motion(moving, fixed, method)
        assert align.edge_misalign_proxy(moving, fixed) == jalign.edge_misalign_proxy(moving, fixed)
        np.testing.assert_array_equal(align.sobel_edges(moving), jalign.sobel_edges(moving))


def test_batch_checker_csv_and_aligned_cube_equal_jax(tmp_path):
    rng = np.random.RandomState(1234)
    low_dir, gt_dir = tmp_path / "low", tmp_path / "gt"
    low_dir.mkdir()
    gt_dir.mkdir()
    base = _scene(rng)
    cube_gt = np.stack([base * (1 + 0.1 * b) for b in range(5)], axis=-1).astype(np.float32)
    sio.savemat(gt_dir / "ok.mat", {"data": cube_gt})
    sio.savemat(low_dir / "ok.mat", {"data": cube_gt * 0.3})
    sio.savemat(gt_dir / "bad.mat", {"data": cube_gt})
    sio.savemat(low_dir / "bad.mat", {"data": np.roll(cube_gt, (-4, -5), axis=(0, 1)) * 0.3})
    save_envi(str(gt_dir / "env"), cube_gt)
    save_envi(str(low_dir / "env"), np.roll(cube_gt, (2, -3), axis=(0, 1)) * 0.5, interleave="bip")
    sio.savemat(low_dir / "orphan.mat", {"data": cube_gt})
    outs = {}
    for name, mod in (("port", align), ("jax", jalign)):
        out = tmp_path / name
        results = mod.check_misregistration_hsi(
            str(low_dir), str(gt_dir), str(out / "r.csv"),
            opts=mod.AlignOptions(save_aligned_dir=str(out / "aligned"), verbose=False))
        outs[name] = (out, results)
    (ours, got), (theirs, want) = outs["port"], outs["jax"]
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert got[0].flag_misaligned and len(got) == 3
    assert open(ours / "r.csv", "rb").read() == open(theirs / "r.csv", "rb").read()
    with open(ours / "r.csv") as fh:
        assert len(list(csv.DictReader(fh))) == 3
    for name in ("bad.mat", "ok.mat", "env.mat"):
        np.testing.assert_array_equal(sio.loadmat(ours / "aligned" / name)["data"],
                                      sio.loadmat(theirs / "aligned" / name)["data"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="No matching cube filenames"):
        align.check_misregistration_hsi(str(tmp_path / "empty"), str(gt_dir),
                                        str(tmp_path / "x.csv"))


@pytest.mark.skipif(not HAVE_MPL, reason="matplotlib is not installed")
def test_align_main_with_previews(tmp_path):
    rng = np.random.RandomState(7)
    low_dir, gt_dir = tmp_path / "low", tmp_path / "gt"
    low_dir.mkdir()
    gt_dir.mkdir()
    cube = np.stack([_scene(rng) * (1 + 0.1 * b) for b in range(4)], axis=-1).astype(np.float32)
    sio.savemat(gt_dir / "a.mat", {"data": cube})
    sio.savemat(low_dir / "a.mat", {"data": np.roll(cube, (-3, 2), axis=(0, 1)) * 0.3})
    results = align.main(["--low_dir", str(low_dir), "--gt_dir", str(gt_dir), "--out_csv",
                          str(tmp_path / "r.csv"), "--preview_dir", str(tmp_path / "p"),
                          "--flow_method", "proxy"])
    assert len(results) == 1 and results[0].flag_misaligned
    assert os.path.exists(tmp_path / "p" / "a_preview.png")


# ---- doctor ----

@pytest.fixture
def workspace(tmp_path, monkeypatch):
    from tests.conftest import make_synthetic_dataset

    monkeypatch.chdir(tmp_path)
    make_synthetic_dataset(str(tmp_path), np.random.RandomState(1234), h=32, w=32, c=12)
    return tmp_path


DOCTOR = dict(channels=12, global_min=200.0, global_max=4095.0, batch_size=2, patch_size=16,
              epoch=1, train_data="./data/low/train", eval_data="./data/low/eval",
              test_data="./data/low/test", label_dir="./data/high/test", model_name="doc")


def _doctors(**kw):
    from sshslie_tpu.config import Config as JaxConfig
    from sshslie_tpu.doctor import run_doctor as jax_doctor
    from sshslie_torch.config import load_config
    from sshslie_torch.doctor import ENVIRONMENT_CHECKS, run_doctor

    ours = run_doctor(load_config(None, {**DOCTOR, **kw, "device": "cpu"}))
    jcfg = JaxConfig(**{**DOCTOR, **kw, "attention_impl": "xla"})
    jcfg.finalize()
    theirs = jax_doctor(jcfg)
    env = [r for r in ours.rows if r[1] in ENVIRONMENT_CHECKS]
    assert [r[1] for r in env] == ["torch device", "nvcc", "kernel build", "native patch sampler"]
    assert env[0][0] == "PASS" and "cpu" in env[0][2]
    rest = [(lvl, check, detail.replace(".pth", ".ckpt")) for lvl, check, detail in ours.rows
            if check not in ENVIRONMENT_CHECKS]
    jax_env = ("jax backend", "native patch sampler", "compile cache dir")
    assert rest == [r for r in theirs.rows if r[1] not in jax_env]
    return ours


@pytest.mark.parametrize("kw", [
    {}, {"channels": 99, "patch_size": 100, "phase": "train"}, {"global_max": 100.0, "phase": "train"},
    {"global_min": 0.0, "global_max": 100.0, "phase": "train"}, {"global_max": 1e9, "phase": "train"},
    {"normalization": "self", "global_max": 100.0, "phase": "train"}, {"batch_size": 64, "phase": "train"},
    {"train_data": "./nope", "phase": "train"}, {"phase": "test", "test_timestamp": "20990101_000000"},
    {"data_pattern": "*.hdr", "phase": "train"}, {"lazy_loading": True, "phase": "train_and_test"},
], ids=["healthy", "channels-patch", "inverted", "over-max", "tiny-max", "self", "batch",
        "no-dir", "no-ckpt", "no-hdr", "lazy"])
def test_doctor_rows_equal_jax(workspace, kw):
    rep = _doctors(**kw)
    assert rep.failed == any(lvl == "FAIL" for lvl, _, _ in rep.rows)


def test_doctor_envi_store_and_gt_pairing(workspace):
    for d in ("low/train", "low/test"):
        for f in os.listdir(f"data/{d}"):
            cube = sio.loadmat(f"data/{d}/{f}")["data"]
            save_envi(f"data/{d}/{os.path.splitext(f)[0]}", cube.astype(np.float32))
    os.remove("data/high/test/t0.mat")
    rep = _doctors(data_pattern="*.hdr")
    levels = {check: lvl for lvl, check, _ in rep.rows}
    assert levels["train files"] == "PASS" and levels["test GT pairing"] == "WARN"


def test_doctor_exit_codes(workspace, capsys):
    from sshslie_torch.doctor import main as doctor_main

    flags = ["--config", "", "--device", "cpu", "--model_name", "doc"]
    assert doctor_main(flags + ["--channels", "12", "--train_data", "./data/low/train",
                                "--eval_data", "./data/low/eval", "--test_data", "./data/low/test",
                                "--label_dir", "./data/high/test", "--global_min", "200.0",
                                "--global_max", "4095.0", "--patch_size", "16"]) == 0
    assert doctor_main(flags + ["--channels", "99", "--train_data", "./data/low/train",
                                "--phase", "train"]) == 1
    assert doctor_main(flags + ["--phase", "test", "--test_timestamp", "nope"]) == 1
    out = capsys.readouterr().out
    assert "[PASS] torch device — cpu" in out and "[FAIL] checkpoints" in out


def test_doctor_without_card_fails_the_device_row(workspace, monkeypatch):
    import torch

    from sshslie_torch.config import load_config
    from sshslie_torch.doctor import run_doctor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = run_doctor(load_config(None, DOCTOR))
    assert rep.rows[0][:2] == ("FAIL", "torch device") and "no CUDA device" in rep.rows[0][2]


# ---- serve_client ----

class _Recorder(http.server.BaseHTTPRequestHandler):
    """Records each request and answers with the request's f32 cube doubled."""

    seen: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.path, {k: v for k, v in self.headers.items()
                                      if k.startswith("X-") or k == "Content-Encoding"}, body))
        from sshslie_torch import serve

        blob, headers = serve.encode_cube(np.full((2, 3, 4), 7.0, np.float32), "f32")
        self.send_response(200)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def log_message(self, *args):
        pass


def test_serve_client_requests_equal_jax(tmp_path):
    from sshslie_torch import serve_client

    spec = importlib.util.spec_from_file_location("jax_serve_client",
                                                  os.path.join(ROOT, "scripts", "serve_client.py"))
    jclient = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jclient)
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Recorder)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    cube = _cube(9, 10, 12, 4)
    try:
        for req, resp, compress in (("f32", "f32", ""), ("bf16", "u16", ""), ("u16", "bf16", "zlib"),
                                    ("f32", "mat", "zlib")):
            _Recorder.seen.clear()
            for client in (serve_client, jclient):
                result, headers, _ = client.enhance_over_http(
                    url, cube, request_encoding=req, encoding=resp, compress=compress, key="k")
                np.testing.assert_array_equal(result["data"], np.full((2, 3, 4), 7.0, np.float32))
            assert _Recorder.seen[0] == _Recorder.seen[1], (req, resp, compress)
    finally:
        srv.shutdown()


def test_serve_client_round_trip_against_the_port_server(tmp_path):
    from sshslie_torch import serve, serve_client
    from sshslie_torch.config import Config

    cfg = Config(channels=4, patch_size=16, global_min=0.0, global_max=1000.0,
                 serve_pad_multiple=16, device="cpu").finalize()
    service = serve.EnhanceService(cfg, 4)
    srv = serve.EnhanceServer(service, port=0).start()
    try:
        cube = _cube(10, 20, 18, 4)
        hdr, _ = save_envi(str(tmp_path / "in"), cube)
        out = str(tmp_path / "out.mat")
        result = serve_client.main([hdr, out, "--url", f"http://{srv.host}:{srv.port}",
                                    "--request_encoding", "f32", "--encoding", "f32"])
        want = service.enhance(cube)["S"]
        span = float(want.max() - want.min())
        np.testing.assert_allclose(result["data"], want, rtol=0, atol=1e-5 * span)
        np.testing.assert_array_equal(sio.loadmat(out)["data"], result["data"])
    finally:
        srv.shutdown()
