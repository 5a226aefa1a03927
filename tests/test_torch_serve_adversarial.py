"""Every case of ``tests/test_serve_adversarial.py`` against the port's server
(``sshslie_torch/serve.py``), parametrised: each hostile body or header gets
a bounded 4xx (never a 5xx, a hang or a large allocation), counted once in
``sshslie_request_errors_total``, and the server goes on serving."""

import http.client
import io
import json
import zlib

import numpy as np
import pytest
import scipy.io as sio

from sshslie_torch.config import Config
from sshslie_torch.serve import EnhanceServer, EnhanceService, decode_cube_response, encode_cube

CHANNELS = 6


@pytest.fixture(scope="module")
def server():
    cfg = Config(channels=CHANNELS, patch_size=16, global_min=0.0, global_max=4095.0,
                 serve_pad_multiple=16, device="cpu").finalize()
    srv = EnhanceServer(EnhanceService(cfg, CHANNELS), port=0).start()
    yield srv
    srv.shutdown()


def _post(server, body, headers=None, timeout=30):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=timeout)
    try:
        conn.request("POST", "/enhance", body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    return resp.status, data


def _err(data):
    return json.loads(data).get("error", "")


def _errors_total(server):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    for line in text.splitlines():
        if line.startswith("sshslie_request_errors_total"):
            return int(float(line.split()[-1]))
    raise AssertionError("errors counter missing from /metrics")


def _mat(value):
    buf = io.BytesIO()
    sio.savemat(buf, {"data": value})
    return buf.getvalue()


F32 = {"X-Cube-Encoding": "f32", "X-Cube-Shape": f"8x8x{CHANNELS}"}
U16 = {"X-Cube-Encoding": "u16", "X-Cube-Shape": f"4x4x{CHANNELS}"}
DEFLATE = {**F32, "Content-Encoding": "deflate"}
CUBE_BYTES = 8 * 8 * CHANNELS * 4
DEFLATED = zlib.compress(np.zeros((8, 8, CHANNELS), "<f4").tobytes(), 1)

# (id, body, headers, status, a part of the error message or None)
HOSTILE = [
    # dimension bombs: rejected on the declared size, before any allocation
    ("dimension_bomb", b"\x00" * 64,
     {"X-Cube-Encoding": "f32", "X-Cube-Shape": "100000x100000x224"}, 400, "body cap"),
    ("bignum_shape", b"\x00" * 64,
     {**U16, "X-Cube-Shape": "999999999999999999999999x2x3", "X-Cube-Scale": "1.0",
      "X-Cube-Offset": "0.0"}, 400, "body cap"),
    *[(f"malformed_shape[{s}]", b"\x00" * 16, {**F32, "X-Cube-Shape": s}, 400, None)
      for s in ("0x8x6", "-1x8x6", "8x8", "8x8x6x1", "axbxc", "", "8x8x", "1e3x8x6")],
    ("missing_shape_header", b"\x00" * 16, {"X-Cube-Encoding": "f32"}, 400, "X-Cube-Shape"),
    # truncated, oversized, misaligned bodies
    ("truncated_binary_body", b"\x00" * (CUBE_BYTES // 2), F32, 400, None),
    ("oversized_binary_body", b"\x00" * (CUBE_BYTES * 2), F32, 400, None),
    ("misaligned_body", b"\x00" * (CUBE_BYTES + 3), F32, 400, None),
    # u16 scale and offset hostility
    *[(f"u16_scale[{sc},{off}]", np.zeros((4, 4, CHANNELS), "<u2").tobytes(),
       {**U16, "X-Cube-Scale": sc, "X-Cube-Offset": off}, 400, "X-Cube-Scale")
      for sc, off in (("inf", "0.0"), ("nan", "0.0"), ("1e999", "0.0"), ("1.0", "-inf"),
                      ("abc", "0.0"), ("1.0", "0,5"))],
    ("u16_missing_scale_headers", np.zeros((4, 4, CHANNELS), "<u2").tobytes(), U16, 400, None),
    # deflate bombs: 16 MB of zeros in ~16 KB, bounded by the declared cube
    ("zlib_bomb", zlib.compress(b"\x00" * (16 << 20), 9), DEFLATE, 400, "bound"),
    ("deflate_garbage", b"not-deflate-data" * 4, DEFLATE, 400, "decompress"),
    ("deflate_truncated", DEFLATED[: len(DEFLATED) // 2], DEFLATE, 400, "truncated|decompress"),
    # hostile .mat containers
    ("garbage_mat", b"A" * 4096, {}, 400, ".mat"),
    ("fake_hdf5_magic", b"\x89HDF\r\n\x1a\n" + b"junk" * 1024, {}, 400, "v7.3"),
    ("mat_char_variable", _mat("not a cube"), {}, 400, None),
    ("mat_wrong_rank", _mat(np.zeros((8, 8), np.float32)), {}, 400, "expected (H, W"),
    ("mat_wrong_channels", _mat(np.zeros((8, 8, CHANNELS + 3), np.float32)), {}, 400, None),
]


@pytest.mark.parametrize("body,headers,status,msg", [c[1:] for c in HOSTILE],
                         ids=[c[0] for c in HOSTILE])
def test_hostile_request_is_a_counted_4xx(server, body, headers, status, msg):
    before = _errors_total(server)
    got, data = _post(server, body, headers)
    assert got == status, _err(data)
    if msg:
        assert any(m in _err(data) for m in msg.split("|")), _err(data)
    assert _errors_total(server) == before + 1


def test_zlib_bomb_is_small_on_the_wire():
    assert len(dict((c[0], c[1]) for c in HOSTILE)["zlib_bomb"]) < 128 << 10


@pytest.mark.parametrize("length,status", [(str(64 << 30), 413), ("zebra", 400), ("-5", 400)],
                         ids=["past_cap_413_before_read", "garbage", "negative"])
def test_content_length_hostility(server, length, status):
    before = _errors_total(server)
    conn = http.client.HTTPConnection(server.host, server.port, timeout=30)
    try:
        conn.putrequest("POST", "/enhance")
        conn.putheader("Content-Length", length)
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == status
        resp.read()
    finally:
        conn.close()
    assert _errors_total(server) == before + 1


def test_decode_rejects_unknown_encoding_header():
    with pytest.raises(ValueError):
        decode_cube_response(b"", {"X-Cube-Encoding": "pickle"})


def test_decode_u16_f32_affine_accuracy():
    """The in-place float32 affine stays inside the u16 quantization step."""
    cube = (np.random.RandomState(0).rand(16, 16, 4) * 4000).astype(np.float32)
    blob, headers = encode_cube(cube, "u16")
    back = decode_cube_response(blob, headers)
    assert np.max(np.abs(back - cube)) <= (cube.max() - cube.min()) / 65535.0


def test_server_survives_hostility_and_counts_errors(server):
    assert _errors_total(server) >= len(HOSTILE) + 3
    rng = np.random.RandomState(2)
    status, data = _post(server, _mat((rng.rand(8, 8, CHANNELS) * 100).astype(np.float32)),
                         timeout=120)
    assert status == 200
    assert decode_cube_response(data, {"X-Cube-Encoding": "mat"}).shape == (8, 8, CHANNELS)
