"""The port's serving (``sshslie_torch/serve.py``) against the JAX package's
(``sshslie_tpu/serve.py``), on the CPU, with the same seeded weights (the
JAX service's params through ``interop.jax_params_to_state_dict``).

* Wire bytes: ``encode_cube`` equal to JAX's for f32, bf16 and u16, with and
  without zlib; each package decodes the other's payloads, ``raw=True``
  included.
* ``enhance``: S within 1e-5 x (max - min) of the JAX service on ragged shapes
  that need bucket padding (float32 sums in another order; measured ~1e-7 of
  the span), the artifacts within 1e-5.
* The device-decode path (u16/bf16 request bodies) against the host path with
  the tolerances of ``tests/test_serve.py``; the u16 passthrough within 1 LSB
  of JAX's, its headers within 1e-6 relative.
* Micro-batching, reload and its token, ``/metrics``, ``/health``, ``/stats``
  and the 400s; int8 and int4 services within the JAX tests' bounds and
  within 1e-5 x span of the JAX quantized services; ``runner.main`` with
  ``phase: serve``.
* The spans of one u16 request under the profiler: ``serve.request`` with its
  lock waits, upload, decode, forward, sync and fetch under its id; the
  codes bit for bit those of the same request with no profiler.
"""

import concurrent.futures as cf
import http.client
import io
import json
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax

from sshslie_tpu import serve as jserve
from sshslie_tpu.config import Config as JaxConfig
from sshslie_torch import interop, serve
from sshslie_torch.config import Config, load_config

CHANNELS = 6
SPAN = 4095.0
BASE = dict(channels=CHANNELS, patch_size=16, global_min=0.0, global_max=SPAN,
            serve_pad_multiple=16)


def _port_cfg(**kw) -> Config:
    return Config(**{**BASE, "device": "cpu", **kw}).finalize()


@pytest.fixture(scope="module")
def jax_service():
    return jserve.EnhanceService(JaxConfig(**BASE, attention_impl="xla").finalize(), CHANNELS)


@pytest.fixture(scope="module")
def state_dict(jax_service):
    return interop.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                   jax_service.params))


@pytest.fixture(scope="module")
def service(state_dict):
    return serve.EnhanceService(_port_cfg(), CHANNELS, state_dict=state_dict)


@pytest.fixture(scope="module")
def server(service):
    srv = serve.EnhanceServer(service, port=0).start()
    yield srv
    srv.shutdown()


def _cube(seed, h, w, scale=4000.0):
    return (np.random.RandomState(seed).rand(h, w, CHANNELS) * scale).astype(np.float32)


def _post(server, body, headers=None, query=""):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    try:
        conn.request("POST", "/enhance" + query, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp, resp.read()
    finally:
        conn.close()


def _post_mat(server, cube, query="", key="data"):
    buf = io.BytesIO()
    sio.savemat(buf, {key: cube})
    return _post(server, buf.getvalue(), query=query)


def _get(server, path):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp, resp.read()
    finally:
        conn.close()


# -- wire formats ----------------------------------------------------------------

@pytest.mark.parametrize("compress", ["", "zlib"])
@pytest.mark.parametrize("encoding", ["f32", "bf16", "u16"])
def test_encode_cube_bytes_equal_jax(encoding, compress):
    cube = _cube(1, 9, 7) - 300.0
    cube[0, 0, 0] = np.float32(1.00390625)       # a bf16 tie, rounded to even
    blob, headers = serve.encode_cube(cube, encoding, compress)
    jblob, jheaders = jserve.encode_cube(cube, encoding, compress)
    assert blob == jblob
    assert headers == jheaders


@pytest.mark.parametrize("encoding", ["mat", "f32", "bf16", "u16"])
def test_decode_reads_the_other_package(encoding):
    cube = _cube(2, 8, 5)
    for enc_fn, blob_from in ((serve.encode_cube, "port"), (jserve.encode_cube, "jax")):
        blob, headers = enc_fn(cube, encoding, "zlib" if encoding == "u16" else "")
        got = serve.decode_cube_response(blob, headers)
        want = jserve.decode_cube_response(blob, headers)
        np.testing.assert_array_equal(got, want, err_msg=blob_from)
        assert got.dtype == np.float32
        if encoding in ("bf16", "u16"):
            q, s, o = serve.decode_cube_response(blob, headers, raw=True)
            jqv, js, jo = jserve.decode_cube_response(blob, headers, raw=True)
            np.testing.assert_array_equal(q, np.asarray(jqv).view(np.uint16))
            assert (s, o) == (js, jo)


def test_encode_cube_unit():
    cube = np.linspace(-3.0, 7.0, 4 * 5 * 2, dtype=np.float32).reshape(4, 5, 2)
    for enc in ("mat", "f32", "bf16", "u16"):
        blob, headers = serve.encode_cube(cube, enc)
        tol = {"mat": 0, "f32": 0, "bf16": 0.05, "u16": 10.0 / 65535}[enc]
        np.testing.assert_allclose(serve.decode_cube_response(blob, headers), cube,
                                   atol=max(tol, 1e-7))
    const = np.full((3, 3, 2), 2.5, np.float32)
    blob, headers = serve.encode_cube(const, "u16")
    np.testing.assert_allclose(serve.decode_cube_response(blob, headers), const)
    with pytest.raises(ValueError, match="unknown encoding"):
        serve.encode_cube(cube, "f64")
    with pytest.raises(ValueError, match="unknown compress"):
        serve.encode_cube(cube, "f32", compress="lz4")


def test_deflate_bound_clamped_against_giant_declared_shape(monkeypatch):
    import zlib

    monkeypatch.setattr(serve, "_MAX_BODY_BYTES", 1 << 20)
    bomb = zlib.compress(b"\x00" * (8 << 20), 1)
    with pytest.raises(ValueError, match="body cap"):
        serve.decode_cube_response(bomb, {"X-Cube-Encoding": "f32",
                                          "X-Cube-Shape": "100000x100000x224",
                                          "Content-Encoding": "deflate"})
    cube = np.ones((4, 4, CHANNELS), np.float32)
    blob, h = serve.encode_cube(cube, "f32", compress="zlib")
    with pytest.raises(ValueError, match="truncated"):
        serve.decode_cube_response(blob[:-6], h)


@pytest.mark.parametrize("normalization", [None, "self", "global_normalization",
                                           "per_channel_normalization",
                                           "per_channel_standardization"])
def test_normalize_like_load_torch_matches_host_and_jax(normalization):
    from sshslie_tpu.utils import io_hsi as jio
    from sshslie_torch.utils import io_hsi as tio

    x = _cube(5, 9, 7) - 150.0
    kw = dict(max_val=SPAN, min_val=238.0)
    got = tio.normalize_like_load_torch(torch.from_numpy(x.copy()), normalization, **kw).numpy()
    # Outputs of order 1; float32 reductions (max, mean, std) in another order.
    for want in (tio.normalize_like_load(x.copy(), normalization, **kw),
                 np.asarray(jio.normalize_like_load_jnp(x, normalization, **kw))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the service against JAX's ---------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 24), (17, 18), (33, 40)])
def test_enhance_matches_jax(service, jax_service, shape):
    cube = _cube(3, *shape)
    got = service.enhance(cube, artifacts=True)
    want = jax_service.enhance(cube, artifacts=True)
    assert got["S"].shape == cube.shape and got["seconds"] > 0
    np.testing.assert_allclose(got["S"], want["S"], atol=1e-5 * SPAN)
    for name in ("R_low", "I_low", "I_delta"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5, err_msg=name)


def test_shape_buckets_and_warmup(service):
    service.enhance(_cube(4, 17, 18, 100.0))
    assert (32, 32) in service.stats()["buckets"]
    service.warmup([(40, 40)])
    assert (48, 48) in service.stats()["buckets"]
    with pytest.raises(ValueError):
        service.enhance(np.zeros((8, 8, CHANNELS + 1), np.float32))


def test_parse_warmup():
    assert serve.parse_warmup("512x512, 1024X768,") == [(512, 512), (1024, 768)]
    assert serve.parse_warmup("") == []


def test_reduced_wire_fetch_matches_jax(service, jax_service):
    cube = _cube(11, 20, 20)
    ref = service.enhance(cube, wire="f32")["S"]
    span = float(ref.max() - ref.min())
    for wire, tol in (("bf16", 0.01 * float(np.abs(ref).max())), ("u16", span / 65000.0)):
        got = service.enhance(cube, wire=wire)["S"]
        np.testing.assert_allclose(got, ref, atol=tol)
        np.testing.assert_allclose(got, jax_service.enhance(cube, wire=wire)["S"],
                                   atol=tol + 1e-5 * SPAN)


def test_u16_passthrough_within_one_lsb_of_jax(server, service, jax_service):
    cube = _cube(13, 24, 24)
    got = service.enhance(cube, wire="u16_wire")["S_wire"]
    want = jax_service.enhance(cube, wire="u16_wire")["S_wire"]
    assert got["q"].dtype == np.uint16 and got["q"].shape == cube.shape
    assert int(np.abs(got["q"].astype(np.int32) - want["q"].astype(np.int32)).max()) <= 1
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-6)
    np.testing.assert_allclose(got["offset"], want["offset"], rtol=1e-6, atol=1e-6)
    # Over HTTP: the body is the service's codes, the headers its affine.
    resp, body = _post_mat(server, cube, "?encoding=u16")
    assert resp.status == 200, body
    np.testing.assert_array_equal(np.frombuffer(body, "<u2").reshape(cube.shape), got["q"])
    assert float(resp.headers["X-Cube-Scale"]) == pytest.approx(got["scale"], rel=1e-8)


def test_reduced_fetch_crops_before_quantizing(service):
    h = w = 20
    real = np.linspace(0.0, 1.0, h * w * CHANNELS, dtype=np.float32).reshape(h, w, CHANNELS)
    padded = np.full((32, 32, CHANNELS), 1e6, np.float32)
    padded[:h, :w] = real
    got = service._fetch_reduced(torch.from_numpy(padded), "u16", h, w)
    assert got.shape == (h, w, CHANNELS)
    assert float(np.abs(got - real).max()) <= 2.0 / 65535.0
    np.testing.assert_allclose(service._fetch_reduced(torch.from_numpy(padded), "bf16", h, w),
                               real, atol=0.01)


class TestDeviceDecodedRequests:
    def test_accepts_encoded_requests_gating(self, service, state_dict):
        assert service.accepts_encoded_requests
        batched = serve.EnhanceService(_port_cfg(serve_max_batch=4), CHANNELS,
                                       state_dict=state_dict)
        assert not batched.accepts_encoded_requests
        batched.batcher.close()
        std = serve.EnhanceService(_port_cfg(normalization="per_channel_standardization"),
                                   CHANNELS, state_dict=state_dict)
        assert not std.accepts_encoded_requests

    @pytest.mark.parametrize("encoding", ["u16", "bf16"])
    def test_enhance_encoded_matches_host_path_and_jax(self, service, jax_service, encoding):
        cube = _cube(21, 20, 24)                 # padded to the 32x32 bucket
        blob, headers = serve.encode_cube(cube, encoding)
        want = service.enhance(serve.decode_cube_response(blob, headers))["S"]
        q, scale, offset = serve.decode_cube_response(blob, headers, raw=True)
        got = service.enhance_encoded(q, encoding, scale, offset)["S"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=0.5, rtol=1e-4)
        jq, js, jo = jserve.decode_cube_response(blob, headers, raw=True)
        np.testing.assert_allclose(got, jax_service.enhance_encoded(jq, encoding, js, jo)["S"],
                                   atol=1e-5 * SPAN)

    def test_enhance_encoded_rejects_bad_inputs(self, service):
        q = np.zeros((8, 8, CHANNELS), np.uint16)
        with pytest.raises(ValueError, match="u16/bf16"):
            service.enhance_encoded(q, "f32", 1.0, 0.0)
        with pytest.raises(ValueError, match="expected"):
            service.enhance_encoded(q[..., :-1], "u16", 1.0, 0.0)

    def test_http_binary_request_uses_device_path(self, server, service):
        cube = _cube(22, 24, 24)
        blob, headers = serve.encode_cube(cube, "u16")
        resp, body = _post(server, blob, headers)
        assert resp.status == 200, body
        assert "u16" in service._encoded_fns
        want = service.enhance(serve.decode_cube_response(blob, headers))["S"]
        np.testing.assert_allclose(serve.decode_cube_response(body, resp.headers), want,
                                   atol=1.0, rtol=1e-3)


# -- HTTP ------------------------------------------------------------------------

def test_http_health_names_the_torch_device(server):
    resp, body = _get(server, "/health")
    payload = json.loads(body)
    assert resp.status == 200 and payload["status"] == "ok"
    assert payload["backend"] == "cpu" and payload["channels"] == CHANNELS


def test_http_enhance_roundtrip_and_artifacts(server, service):
    cube = _cube(2, 18, 18)
    resp, body = _post_mat(server, cube)
    assert resp.status == 200 and float(resp.headers["X-Inference-Seconds"]) > 0
    np.testing.assert_allclose(sio.loadmat(io.BytesIO(body))["data"],
                               service.enhance(cube)["S"], rtol=1e-5, atol=1e-5)
    resp, body = _post_mat(server, cube, "?artifacts=1")
    mat = sio.loadmat(io.BytesIO(body))
    assert {"data", "R_low", "I_low", "I_delta"} <= set(mat)
    assert mat["I_delta"].shape == (18, 18, 1)
    resp, _ = _post_mat(server, cube, "?key=ref", key="ref")
    assert resp.status == 200


def test_wire_encodings_roundtrip(server, service):
    cube = _cube(7, 24, 24)
    ref = service.enhance(cube)["S"]
    span = float(ref.max() - ref.min())
    for enc, tol in (("mat", 0.0), ("f32", 0.0), ("bf16", 0.004 * float(np.abs(ref).max())),
                     ("u16", 3.0 * span / 65535.0)):
        resp, body = _post_mat(server, cube, f"?encoding={enc}&compress=zlib")
        assert resp.status == 200, body
        assert resp.headers["Content-Encoding"] == "deflate"
        np.testing.assert_allclose(serve.decode_cube_response(body, resp.headers), ref,
                                   atol=max(tol, 1e-6))
    # binary request bodies, deflated too
    for enc in ("f32", "bf16", "u16"):
        blob, headers = serve.encode_cube(cube, enc, "zlib")
        resp, body = _post(server, blob, headers)
        assert resp.status == 200, body


def test_http_bad_requests(server):
    cube = _cube(5, 8, 8, 1.0)
    resp, body = _post_mat(server, cube, key="wrong")
    assert resp.status == 400 and "not found" in json.loads(body)["error"]
    resp, _ = _post(server, b"")
    assert resp.status == 400
    for query, msg in (("?encoding=ascii", b"unknown encoding"),
                       ("?compress=gzip", b"unknown compress"),
                       ("?artifacts=1&encoding=u16", b"requires encoding=mat")):
        resp, body = _post_mat(server, cube, query)
        assert resp.status == 400 and msg in body
    blob, headers = serve.encode_cube(np.ones((8, 8, CHANNELS), np.float32), "f32")
    resp, body = _post(server, blob, {**headers, "X-Cube-Shape": "8xNOPEx6"})
    assert resp.status == 400 and b"malformed X-Cube-Shape" in body
    resp, _ = _post(server, blob[:-8], headers)
    assert resp.status == 400
    resp, _ = _get(server, "/nope")
    assert resp.status == 404


def test_stats_and_metrics_histogram_contract(server, service):
    _post_mat(server, _cube(8, 16, 16))
    resp, body = _get(server, "/stats")
    stats = json.loads(body)
    assert resp.status == 200 and stats["requests"] >= 1 and stats["avg_seconds"] > 0
    txt = service.metrics_text()
    vals, cum = {}, []
    for line in txt.splitlines():
        if line.startswith("#"):
            continue
        name, v = line.rsplit(" ", 1)
        if name.startswith("sshslie_inference_seconds_bucket"):
            cum.append(float(v))
        else:
            vals[name] = float(v)
    n = service.stats()["requests"]
    assert vals["sshslie_requests_total"] == n == vals["sshslie_inference_seconds_count"]
    assert cum == sorted(cum) and cum[-1] == n
    assert vals["sshslie_inference_seconds_sum"] == pytest.approx(
        service.stats()["avg_seconds"] * n)
    assert vals["sshslie_compiled_buckets"] == len(service.stats()["buckets"])
    jtxt = jserve.EnhanceService.metrics_text(service)
    assert [l.split(" ")[0] for l in txt.splitlines() if not l.startswith("#")] == \
        [l.split(" ")[0] for l in jtxt.splitlines() if not l.startswith("#")]


def test_metrics_endpoint_counts_errors(server):
    def errors():
        resp, body = _get(server, "/metrics")
        assert resp.getheader("Content-Type").startswith("text/plain")
        return float([l for l in body.decode().splitlines()
                      if l.startswith("sshslie_request_errors_total ")][0].split()[-1])

    before = errors()
    _post_mat(server, _cube(3, 8, 8), "?encoding=nope")
    _get(server, "/bogus")
    assert errors() >= before + 2


# -- micro-batching ----------------------------------------------------------------

class TestMicroBatching:
    @pytest.fixture(scope="class")
    def batched_service(self, state_dict):
        svc = serve.EnhanceService(_port_cfg(serve_max_batch=4, serve_batch_window_ms=50.0),
                                   CHANNELS, state_dict=state_dict)
        yield svc
        svc.batcher.close()

    def test_concurrent_requests_coalesce_and_match_single(self, batched_service, service):
        cubes = [_cube(9 + i, 16, 16) for i in range(4)]
        batched_service.warmup([(16, 16)])
        with cf.ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda c: batched_service.enhance(c)["S"], cubes))
        for cube, got in zip(cubes, outs):
            np.testing.assert_allclose(got, service.enhance(cube)["S"], atol=1e-5 * SPAN)
        stats = batched_service.stats()
        assert stats["batched_runs"] >= 1 and stats["max_batch_seen"] >= 2, stats
        txt = batched_service.metrics_text()
        assert "sshslie_batched_runs_total" in txt and "sshslie_max_batch_seen" in txt

    def test_batcher_propagates_errors(self, batched_service):
        with pytest.raises(ValueError):
            batched_service.enhance(np.zeros((8, 8, CHANNELS + 2), np.float32))

    def test_pow2_and_submit_after_close_fails_fast(self):
        assert [serve._round_up_pow2(n, c) for n, c in ((1, 8), (3, 8), (5, 4))] == [1, 4, 4]
        b = serve._MicroBatcher(lambda xs: xs, max_batch=2, window_ms=1.0)
        assert b.close()
        fut = b.submit((8, 8), np.zeros((8, 8, 1), np.float32))
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=1)


# -- reload ------------------------------------------------------------------------

def _save_scaled(path, state_dict, factor, epoch):
    return interop.save_checkpoint(str(path), {k: v * factor for k, v in state_dict.items()},
                                   epoch=epoch)


def test_reload_hot_swaps_weights(tmp_path, state_dict):
    svc = serve.EnhanceService(_port_cfg(), CHANNELS, state_dict=state_dict)
    cube = _cube(11, 16, 16, 100.0)
    before = svc.enhance(cube)["S"]
    ckpt = _save_scaled(tmp_path / "hot.pth", state_dict, 1.1, 9)
    info = svc.reload(ckpt)
    assert info["epoch"] == 9 and info["reloads"] == 1
    after = svc.enhance(cube)["S"]
    assert not np.allclose(before, after)
    fresh = serve.EnhanceService(_port_cfg(), CHANNELS, checkpoint_path=ckpt)
    np.testing.assert_array_equal(after, fresh.enhance(cube)["S"])
    assert len(svc.stats()["buckets"]) >= 1
    with pytest.raises(ValueError):
        serve.EnhanceService(_port_cfg(), CHANNELS).reload()
    # A bad file changes nothing.
    with pytest.raises(FileNotFoundError):
        svc.reload(str(tmp_path / "missing.pth"))
    np.testing.assert_array_equal(svc.enhance(cube)["S"], after)


def test_http_reload_token(tmp_path, server, state_dict):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    conn.request("POST", "/reload?checkpoint=/nope/missing.pth")
    resp = conn.getresponse()
    assert resp.status == 403 and "X-Reload-Token" in json.loads(resp.read())["error"]
    conn.close()
    svc = serve.EnhanceService(_port_cfg(serve_reload_token="s3cret"), CHANNELS,
                               state_dict=state_dict)
    srv = serve.EnhanceServer(svc, port=0).start()
    try:
        ckpt = _save_scaled(tmp_path / "h2.pth", state_dict, 1.0, 3)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        for token, status in (("s3cret", 200), ("wrong", 403), ("", 403)):
            conn.request("POST", f"/reload?checkpoint={ckpt}", headers={"X-Reload-Token": token})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            assert resp.status == status, payload
        assert svc.reload_count == 1
        conn.request("POST", "/reload?checkpoint=/nope/missing.pth",
                     headers={"X-Reload-Token": "s3cret"})
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
        conn.close()
    finally:
        srv.shutdown()


# -- quantized services --------------------------------------------------------------

@pytest.mark.parametrize("fmt,bound", [("int8", 30.0), ("int4", 300.0)])
def test_quantized_serving_matches_jax(tmp_path, fmt, bound, jax_service, state_dict, service):
    q = serve.EnhanceService(_port_cfg(serve_quantize=fmt), CHANNELS, state_dict=state_dict)
    jq = jserve.EnhanceService(JaxConfig(**BASE, attention_impl="xla", serve_quantize=fmt)
                               .finalize(), CHANNELS, params=jax_service._params_template)
    cube = _cube(21 if fmt == "int8" else 22, 20, 20)
    S_q = q.enhance(cube)["S"]
    assert S_q.shape == cube.shape
    assert np.abs(service.enhance(cube)["S"] - S_q).max() < bound
    np.testing.assert_allclose(S_q, jq.enhance(cube)["S"], atol=1e-5 * SPAN)
    # The device weights are the quantized ones, and reload quantizes again.
    assert all(v.q.dtype in (torch.int8, torch.uint8) for v in q.params.values()
               if hasattr(v, "q"))
    info = q.reload(_save_scaled(tmp_path / "q.pth", state_dict, 1.0, 1))
    assert info["epoch"] == 1 and q._infer.qparams is q.params
    np.testing.assert_allclose(q.enhance(cube)["S"], S_q, atol=1e-4)


def test_quantized_serving_rejects_mesh(monkeypatch, state_dict):
    """JAX's ValueError, before any weight is touched, whether the mesh is
    the config's or the service's; without quantization a mesh service
    builds (``tests/test_torch_serve_mesh.py`` serves on gloo groups)."""
    from sshslie_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="single-chip"):
        serve.EnhanceService(_port_cfg(serve_quantize="int8", mesh_shape="8"), CHANNELS)
    mesh = serve.EnhanceService(_port_cfg(mesh_shape="1"), CHANNELS, state_dict=state_dict,
                                mesh=make_mesh("1"))
    assert mesh.leads and not mesh.accepts_encoded_requests
    monkeypatch.setattr(serve.EnhanceService, "_new_model", lambda self: pytest.fail("built"))
    with pytest.raises(ValueError, match="single-chip"):
        serve.EnhanceService(_port_cfg(serve_quantize="int8"), CHANNELS, mesh=make_mesh("1"))


# -- the entry point ------------------------------------------------------------------

def test_runner_serve_phase_from_a_port_checkpoint(tmp_path, monkeypatch, state_dict):
    from sshslie_torch import checkpoints, runner

    monkeypatch.chdir(tmp_path)
    cfg = load_config(None, {**BASE, "device": "cpu", "phase": "serve", "model_name": "srv",
                             "test_timestamp": "20990101_000000", "serve_port": 0,
                             "serve_warmup": "16x16", "use_mlflow": False})
    os.makedirs(cfg.test_model_dir)
    interop.save_checkpoint(checkpoints.latest_path(cfg.test_model_dir), state_dict, epoch=1)
    seen = {}

    def serve_once(self):
        # In place of the blocking accept loop: serve on a thread, answer
        # /health and one /enhance, return (serve_from_config shuts it down).
        self.start()
        resp, body = _get(self, "/health")
        seen["health"] = json.loads(body)
        cube = _cube(6, 16, 16)
        resp, body = _post_mat(self, cube)
        seen["status"], seen["shape"] = resp.status, sio.loadmat(io.BytesIO(body))["data"].shape
        seen["S"] = sio.loadmat(io.BytesIO(body))["data"]
        seen["want"] = serve.EnhanceService(_port_cfg(), CHANNELS, state_dict=state_dict) \
            .enhance(cube)["S"]

    monkeypatch.setattr(serve.EnhanceServer, "serve_forever", serve_once)
    assert runner.main(cfg) == {}
    assert seen["health"]["status"] == "ok" and seen["health"]["buckets"] == [[16, 16]]
    assert seen["status"] == 200 and seen["shape"] == (16, 16, CHANNELS)
    np.testing.assert_allclose(seen["S"], seen["want"], rtol=1e-6, atol=1e-5)


def test_serve_phase_missing_checkpoint_is_actionable(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(None, {**BASE, "device": "cpu", "phase": "serve", "model_name": "ghost",
                             "test_timestamp": "20990101_000000", "serve_port": 0})
    with pytest.raises(FileNotFoundError, match="test_timestamp"):
        serve.build_server_from_config(cfg)
    cfg.channels = None
    with pytest.raises(ValueError, match="channels"):
        serve.build_server_from_config(cfg)


def test_encoded_request_records_its_spans_under_the_profiler(service):
    from torch.profiler import ProfilerActivity, profile

    from sshslie_torch.observability import TRACER

    q = np.random.RandomState(5).randint(0, 4096, (20, 24, CHANNELS)).astype(np.uint16)

    def request():
        return service.enhance_encoded(q, "u16", 1.0, 0.0, wire="u16_wire")["S_wire"]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # one small request, not the pool's contention with other workers
    try:
        plain = request()
        TRACER.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            traced = request()
    finally:
        torch.set_num_threads(threads)
    spans = TRACER.spans()
    TRACER.reset()
    np.testing.assert_array_equal(traced["q"], plain["q"])
    assert (traced["scale"], traced["offset"]) == (plain["scale"], plain["offset"])
    (req,) = [r for r in spans if r.name == "serve.request"]
    assert req.parent is None and all(r.root == req.id for r in spans)
    children = sorted(r.name for r in spans if r.parent == req.id)
    assert children == ["serve.decode", "serve.fetch", "serve.forward", "serve.lock_wait",
                        "serve.sync", "serve.upload"]
    (fetch,) = [r for r in spans if r.name == "serve.fetch"]
    assert [r.name for r in spans if r.parent == fetch.id] == ["serve.lock_wait"]
