"""Command-line client of the port's server (``sshslie_torch/serve.py``), as
the JAX package's ``scripts/serve_client.py``.

POSTs a cube (``.mat`` or an ENVI ``.hdr`` pair) to a running server and
writes the enhanced cube:

* ``--request_encoding mat|f32|bf16|u16``: the upload's format (the binary
  ones carry the X-Cube-* headers; u16 halves the bytes at an input error of
  at most range/65535);
* ``--encoding mat|f32|bf16|u16``: the response's format;
* ``--compress zlib``: deflate both ways;
* ``--artifacts``: also R, I_low and I_delta (needs the .mat response).

It encodes and decodes with ``serve.encode_cube`` and
``serve.decode_cube_response``, the server's own helpers.

``python -m sshslie_torch.serve_client --url http://host:8900 cube.mat out.mat
[--request_encoding u16] [--encoding u16] [--compress zlib] [--key data]``
"""

from __future__ import annotations

import argparse
import http.client
import io
import time
import urllib.parse

import numpy as np

from sshslie_torch.serve import WIRE_ENCODINGS, decode_cube_response, encode_cube
from sshslie_torch.utils.io_hsi import load_hsi, save_hsi


def enhance_over_http(
    url: str,
    cube: np.ndarray,
    request_encoding: str = "mat",
    encoding: str = "mat",
    compress: str = "",
    key: str = "data",
    pred_key: str = "data",
    artifacts: bool = False,
    timeout: float = 300.0,
):
    """POST one cube → (result dict, response headers, wall seconds).

    ``result`` maps ``pred_key`` → enhanced cube (+ artifact arrays when
    ``artifacts``); raises RuntimeError with the server's message on any
    non-200."""
    parsed = urllib.parse.urlparse(url if "//" in url else "//" + url)
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or 8900
    blob, headers = encode_cube(cube, request_encoding, compress, mat_key=key)
    query = {"key": key}
    if encoding != "mat":
        query["encoding"] = encoding
    if compress:
        query["compress"] = compress
    if artifacts:
        query["artifacts"] = "1"
    path = "/enhance?" + urllib.parse.urlencode(query)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", path, body=blob, headers=dict(headers))
    resp = conn.getresponse()
    body = resp.read()
    wall = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise RuntimeError(
            f"server returned {resp.status}: {body.decode(errors='replace')}"
        )
    if artifacts:
        import zlib

        import scipy.io as sio

        if resp.headers.get("Content-Encoding", "") == "deflate":
            body = zlib.decompress(body)
        mat = sio.loadmat(io.BytesIO(body))
        result = {k: np.asarray(v) for k, v in mat.items()
                  if not k.startswith("__")}
    else:
        result = {pred_key: decode_cube_response(body, resp.headers,
                                                 mat_key=pred_key)}
    return result, resp.headers, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cube", help=".mat or ENVI .hdr cube to enhance")
    ap.add_argument("out", help="output .mat path for the enhanced cube")
    ap.add_argument("--url", default="http://127.0.0.1:8900")
    ap.add_argument("--request_encoding", default="mat",
                    choices=WIRE_ENCODINGS)
    ap.add_argument("--encoding", default="mat", choices=WIRE_ENCODINGS)
    ap.add_argument("--compress", default="", choices=("", "zlib"))
    ap.add_argument("--artifacts", action="store_true",
                    help="also save R/I_low/I_delta (needs --encoding mat)")
    ap.add_argument("--key", default="data", help="mat key of the input cube")
    ap.add_argument("--pred_key", default="data",
                    help="mat key the server stores predictions under "
                         "(config mat_key_prediction)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    cube = np.asarray(load_hsi(args.cube, args.key), np.float32)
    result, headers, wall = enhance_over_http(
        args.url, cube,
        request_encoding=args.request_encoding, encoding=args.encoding,
        compress=args.compress, key=args.key, pred_key=args.pred_key,
        artifacts=args.artifacts, timeout=args.timeout,
    )
    if args.artifacts:
        import scipy.io as sio

        sio.savemat(args.out, result)  # S + R/I_low/I_delta in one container
    else:
        save_hsi(args.out, result[args.pred_key], key=args.pred_key)
    infer = headers.get("X-Inference-Seconds", "?")
    print(f"{args.cube} {cube.shape} → {args.out} "
          f"[req {args.request_encoding}, resp {args.encoding}"
          f"{'+' + args.compress if args.compress else ''}] "
          f"round-trip {wall:.3f}s (device {infer}s)")
    return result


if __name__ == "__main__":
    main()
