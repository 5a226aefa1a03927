"""Serving on a mesh (``sshslie_torch/serve.py`` with ``mesh``) on gloo
groups, against the JAX package's mesh service on the CPU.

Rank 0 alone answers HTTP; every rank runs the height-sharded forward. Two
groups run at once, each rank this file run as a script (it imports only
``sshslie_torch``) writing one ``.npz``, and beside them ``torchrun
--nproc_per_node 2 -m sshslie_torch --phase serve --mesh_shape 2 --device
cpu``; JAX runs in the pytest process. Sizes: 4 bands, ``serve_pad_multiple``
64, a 64x64 cube (its own bucket) and a 32x24 one (bucket 64x64).

* Two ranks, ``mesh_shape: "2"``, a group timeout of GROUP_TIMEOUT_S: rank 0
  serves over HTTP on 127.0.0.1 port 0 (its own client thread) the aligned
  and ragged cubes, ``artifacts=1``, the bf16 and u16 response wires and a
  u16 request body (decoded on the host on a mesh); a request of the wrong
  channel count and a ``/reload`` of a missing file (4xx, no command sent);
  a ``/reload`` with the token; a request after idling past the group's
  timeout; ``/health``, ``/stats`` and ``/metrics``; then ``shutdown()``.
  The followers start from other weights than rank 0's (they take rank
  0's) and record every command and the S of every forward they ran.
* Four ranks: ``mesh_shape: "4"``, then ``"2x2"`` (space replicas) on the
  same group, the aligned and ragged cubes through ``enhance``.
* S against JAX's ``EnhanceService(mesh=make_mesh(shape))`` and the port's
  one-device service with ``tests/test_serve.py``'s tolerance (rtol 1e-5,
  atol 1e-3 in data units).
* ``serve_quantize`` with a mesh raises JAX's ``ValueError`` on every rank
  before any weight is touched.
* The CLI: rank 0 answers ``/enhance`` (S = the one-device service's on the
  same checkpoint), then SIGINT to torchrun, as Ctrl-C sends it (torchrun
  passes SIGTERM on to the ranks): every rank stops cleanly within seconds.
"""

import http.client
import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.io as sio
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS, PATCH, SPAN = 4, 16, 4095.0
BASE = dict(channels=CHANNELS, patch_size=PATCH, global_min=0.0, global_max=SPAN,
            serve_pad_multiple=64)
CUBES = {"aligned": (64, 64), "ragged": (32, 24)}
TOKEN = "mesh-reload-token"
GROUP_TIMEOUT_S = 5.0            # the two-rank group's collective timeout
IDLE_S = GROUP_TIMEOUT_S + 1.5   # how long that group's rank 0 idles before a request
RUN_TIMEOUT = 240
TS = "20990101_000000"


def _cube(name, channels=CHANNELS):
    h, w = CUBES[name]
    return (np.random.RandomState(len(name)).rand(h, w, channels) * 4000).astype(np.float32)


# ---- the worker: one rank of a group (run as a script; no JAX) ----

def _worker(rank: int, world: int, port: int, out: str) -> None:
    sys.path.insert(0, ROOT)
    from sshslie_torch import serve
    from sshslie_torch.config import Config
    from sshslie_torch.parallel import distributed
    from sshslie_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    # Every rank of the group ready before the rendezvous, which the short
    # group timeout also bounds.
    open(os.path.join(out, f"ready{world}_{rank}"), "w").close()
    while len([f for f in os.listdir(out) if f.startswith(f"ready{world}_")]) < world:
        time.sleep(0.01)
    distributed.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                       world_size=world, rank=rank,
                                       timeout=GROUP_TIMEOUT_S if world == 2 else None)
    sd = torch.load(os.path.join(out, "sd.pt"), weights_only=True)
    res = {}

    def cfg_of(shape, **kw):
        return Config(**{**BASE, "device": "cpu", "attention_impl": "dense", "mesh_shape": shape,
                         "serve_reload_token": TOKEN, **kw}).finalize()

    def recording(svc, key):
        """The follower's commands and the S of its forwards, as it runs them."""
        ops, outs = [], []
        execute = svc._execute

        def run(header, payload=None):
            ops.append(header["op"])
            out = execute(header, payload)
            if header["op"] == "enhance":
                outs.append(out[3].numpy().copy())
            return out
        svc._execute = run
        res[f"{key}/ops"] = ops
        res[f"{key}/S"] = outs

    shapes = ("2",) if world == 2 else ("4", "2x2")
    for shape in shapes:
        mesh = make_mesh(shape)
        try:
            serve.EnhanceService(cfg_of(shape, serve_quantize="int8"), CHANNELS, mesh=mesh)
        except ValueError as e:
            res[f"{shape}/quantize"] = str(e)
        # The followers start from the seeded weights, rank 0 from sd.
        svc = serve.EnhanceService(cfg_of(shape), CHANNELS, mesh=mesh,
                                   state_dict=sd if rank == 0 else None)
        srv = serve.EnhanceServer(svc, port=0)
        if rank != 0:
            res[f"{shape}/bound"] = srv.httpd is not None
            recording(svc, shape)
            srv.serve_forever()
            res[f"{shape}/left"] = True
            continue
        if world == 2:
            _lead_two(svc, srv, res, out)
        else:
            for name in CUBES:
                res[f"{shape}/{name}"] = svc.enhance(_cube(name))["S"]
            srv.shutdown()
    distributed.leave()
    np.savez(os.path.join(out, f"w{world}_rank{rank}.npz"),
             **{k: np.stack(v) if k.endswith("/S") else np.array(v) for k, v in res.items()})


def _lead_two(svc, srv, res, out) -> None:
    """Rank 0 of the two-rank group: its HTTP client, from this process."""
    from sshslie_torch import serve

    sent = []
    post_command = svc._commands.post

    def recorded_post(header):
        sent.append(header["op"])
        post_command(header)
    svc._commands.post = recorded_post
    svc.warmup([(64, 64)])
    srv.start()

    def call(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=dict(headers or {}))
            resp = conn.getresponse()
            return resp.status, resp.headers, resp.read()
        finally:
            conn.close()

    def post(cube, enc="f32", query="?encoding=f32", key="S", body=None):
        blob, hd = body or serve.encode_cube(cube, enc)
        status, rh, data = call("POST", "/enhance" + query, blob, hd)
        assert status == 200, (status, data[:300])
        res[key] = serve.decode_cube_response(data, rh)
        return rh, data

    res["health"] = call("GET", "/health")[2].decode()
    buf = io.BytesIO()
    sio.savemat(buf, {"data": _cube("aligned")})
    post(None, query="", key="S/aligned", body=(buf.getvalue(), {}))
    post(_cube("ragged"), key="S/ragged")
    rh, data = post(_cube("aligned"), query="?artifacts=1", key="S/artifacts")
    arts = sio.loadmat(io.BytesIO(data))
    for k in ("R_low", "I_low", "I_delta"):
        res[f"artifacts/{k}"] = arts[k]
    post(_cube("aligned"), query="?encoding=bf16", key="S/bf16")
    post(_cube("aligned"), query="?encoding=u16", key="S/u16")
    post(None, key="S/u16_body", body=serve.encode_cube(_cube("ragged"), "u16"))
    # Refused on rank 0: no command goes out.
    blob, hd = serve.encode_cube(_cube("ragged", CHANNELS + 1), "f32")
    res["status/channels"] = call("POST", "/enhance?encoding=f32", blob, hd)[0]
    res["status/missing"] = call("POST", "/reload?checkpoint=" + os.path.join(out, "none.pth"),
                                 headers={"X-Reload-Token": TOKEN})[0]
    post(_cube("ragged"), key="S/after_missing")
    new = os.path.join(out, "reload.pth")
    res["status/wrong_token"] = call("POST", f"/reload?checkpoint={new}",
                                     headers={"X-Reload-Token": "wrong"})[0]
    status, _, data = call("POST", f"/reload?checkpoint={new}", headers={"X-Reload-Token": TOKEN})
    res["status/reload"], res["reload"] = status, data.decode()
    post(_cube("ragged"), key="S/reload")
    # Idle past the group's timeout, then a request.
    time.sleep(IDLE_S)
    post(_cube("ragged"), key="S/idle")
    res["stats"] = call("GET", "/stats")[2].decode()
    res["metrics"] = call("GET", "/metrics")[2].decode()
    srv.shutdown()
    try:
        svc.enhance(_cube("ragged"))
    except RuntimeError as e:
        res["after_shutdown"] = str(e)
    res["sent"] = sent


# ---- the pytest side ----

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Groups:
    """The launched groups and CLI run; their results once they end."""

    def __init__(self, out, procs, cli):
        self.out, self.procs, self.cli = out, procs, cli
        self._ranks = {}

    def ranks(self, world):
        if world not in self._ranks:
            logs = []
            for p in self.procs[world]:
                try:
                    logs.append(p.communicate(timeout=RUN_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
            for p, log in zip(self.procs[world], logs):
                assert p.returncode == 0, log[-4000:]
            self._ranks[world] = [
                dict(np.load(os.path.join(self.out, f"w{world}_rank{r}.npz"), allow_pickle=True))
                for r in range(world)]
        return self._ranks[world]


def _jax_params(seed):
    import jax

    from sshslie_tpu.models.enhance import LowLightEnhanceNet as JaxNet
    from sshslie_tpu.train import init_params

    return jax.tree_util.tree_map(np.asarray, init_params(
        JaxNet(input_channels=CHANNELS, attention_impl="xla"), seed, PATCH))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Weights and checkpoints written, the groups and the CLI run started."""
    from sshslie_torch import checkpoints, interop
    from sshslie_torch.config import load_config

    out = str(tmp_path_factory.mktemp("serve_mesh"))
    try:
        ports = (_free_port(), _free_port(), _free_port())
    except OSError as e:  # pragma: no cover - a sandbox without sockets
        pytest.skip(f"cannot allocate a local port: {e}")
    params = _jax_params(3)
    sd = interop.jax_params_to_state_dict(params)
    torch.save(sd, os.path.join(out, "sd.pt"))
    params2 = _jax_params(4)
    interop.save_checkpoint(os.path.join(out, "reload.pth"),
                            interop.jax_params_to_state_dict(params2), epoch=5)
    cli_dir = os.path.join(out, "cli")
    ccfg = load_config(None, {"phase": "serve", "model_name": "srv", "test_timestamp": TS,
                              "channels": CHANNELS})
    os.makedirs(os.path.join(cli_dir, ccfg.test_model_dir))
    interop.save_checkpoint(os.path.join(cli_dir, checkpoints.latest_path(ccfg.test_model_dir)),
                            sd, epoch=1)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    procs = {world: [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), out],
        cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)] for world, port in zip((2, 4), ports)}
    argv = ["--config", "", "--device", "cpu", "--mesh_shape", "2", "--phase", "serve",
            "--model_name", "srv", "--test_timestamp", TS, "--channels", str(CHANNELS),
            "--patch_size", str(PATCH), "--attention_impl", "dense", "--global_min", "0",
            "--global_max", str(SPAN), "--serve_pad_multiple", "64", "--serve_port", "0",
            "--serve_warmup", "64x64", "--use_mlflow", "false"]
    cli = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                            "--master_addr", "127.0.0.1", "--master_port", str(ports[2]),
                            "-m", "sshslie_torch", *argv],
                           cwd=cli_dir, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True, start_new_session=True)
    g = _Groups(out, procs, cli)
    g.params, g.params2, g.sd = params, params2, sd
    yield g
    if cli.poll() is None:
        # torchrun passes SIGTERM on to its ranks, each in a session of its own.
        os.killpg(cli.pid, signal.SIGTERM)
        try:
            cli.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(cli.pid, signal.SIGKILL)
    for p in procs[2] + procs[4]:
        if p.poll() is None:
            p.kill()
            p.communicate()


_JAX = {}


def _jax_service(shape, params):
    """JAX's mesh service (``shape``) on ``params``, one a shape and weights."""
    from sshslie_tpu import serve as jserve
    from sshslie_tpu.config import Config as JaxConfig
    from sshslie_tpu.parallel.mesh import make_mesh

    key = (shape, id(params))
    if key not in _JAX:
        _JAX[key] = jserve.EnhanceService(JaxConfig(**BASE, attention_impl="xla").finalize(),
                                          CHANNELS, params=params, mesh=make_mesh(shape))
    return _JAX[key]


def _one_device(sd):
    from sshslie_torch import serve
    from sshslie_torch.config import Config

    return serve.EnhanceService(Config(**BASE, device="cpu").finalize(), CHANNELS, state_dict=sd)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3, err_msg=what)


@pytest.mark.parametrize("shape,name", [(s, n) for s in ("2", "4", "2x2") for n in CUBES])
def test_mesh_service_matches_jax_and_one_device(groups, shape, name):
    cube = _cube(name)
    ranks = groups.ranks(2 if shape == "2" else 4)
    got = ranks[0][f"S/{name}" if shape == "2" else f"{shape}/{name}"]
    assert got.shape == cube.shape
    _close(got, _jax_service(shape, groups.params).enhance(cube)["S"], "against JAX's mesh service")
    _close(got, _one_device(groups.sd).enhance(cube)["S"], "against the one-device service")
    # Every follower ran the same forward: the whole S, gathered.
    k = ["aligned", "ragged"].index(name)
    for r in ranks[1:]:
        S = r[f"{shape}/S"][k][:cube.shape[0], :cube.shape[1]] * SPAN
        _close(S, got, f"rank {r} against rank 0")


def test_mesh_artifacts_and_response_wires(groups):
    r0 = groups.ranks(2)[0]
    cube = _cube("aligned")
    want = _jax_service("2", groups.params).enhance(cube, artifacts=True)
    _close(r0["S/artifacts"], want["S"], "S")
    for k in ("R_low", "I_low", "I_delta"):
        np.testing.assert_allclose(r0[f"artifacts/{k}"], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    s = r0["S/aligned"]
    # Rounded twice (S on the device, then the denormalised S), half a
    # bfloat16 step (2^-7) each; u16 within one code of the cube's own range.
    np.testing.assert_allclose(r0["S/bf16"], s, rtol=2.0 ** -7, atol=1e-3)
    np.testing.assert_allclose(r0["S/u16"], s, rtol=0, atol=(s.max() - s.min()) / 65535.0 * 1.01)


def test_mesh_u16_body_decodes_on_the_host_as_jax(groups):
    from sshslie_tpu import serve as jserve

    from sshslie_torch import serve

    r0 = groups.ranks(2)[0]
    blob, hd = serve.encode_cube(_cube("ragged"), "u16")
    jsvc = _jax_service("2", groups.params)
    assert not jsvc.accepts_encoded_requests
    _close(r0["S/u16_body"], jsvc.enhance(jserve.decode_cube_response(blob, hd))["S"], "u16 body")


def test_mesh_reload_swaps_the_weights_on_every_rank(groups):
    r0, r1 = groups.ranks(2)
    assert r0["status/missing"] == 400 and r0["status/wrong_token"] == 403
    # The missing file changed nothing, and the followers answered the next request.
    np.testing.assert_array_equal(r0["S/after_missing"], r0["S/ragged"])
    assert r0["status/reload"] == 200
    assert json.loads(str(r0["reload"]))["epoch"] == 5
    cube = _cube("ragged")
    want = _jax_service("2", groups.params2).enhance(cube)["S"]
    _close(r0["S/reload"], want, "after /reload against JAX on the new weights")
    assert np.abs(r0["S/reload"] - r0["S/ragged"]).max() > 1.0
    # Rank 1's eighth forward is the first after the reload.
    _close(r1["2/S"][7][:cube.shape[0], :cube.shape[1]] * SPAN, want, "rank 1's S after /reload")


def test_refused_requests_never_reach_the_followers(groups):
    r0, r1 = groups.ranks(2)
    assert r0["status/channels"] == 400
    sent = [str(op) for op in r0["sent"]]
    # The warmup, 6 requests, the one after the refusals (nothing for the
    # 4xx), the reload, 2 requests and the stop; nothing after the stop.
    assert sent == ["warmup"] + ["enhance"] * 7 + ["reload"] + ["enhance"] * 2 + ["stop"]
    assert [str(op) for op in r1["2/ops"]] == sent[:-1]


def test_mesh_health_stats_metrics_on_rank0_alone(groups):
    r0, r1 = groups.ranks(2)
    health = json.loads(str(r0["health"]))
    assert health["status"] == "ok" and health["backend"] == "cpu"
    assert health["channels"] == CHANNELS and health["buckets"] == [[64, 64]]
    stats = json.loads(str(r0["stats"]))
    assert stats["requests"] == 9 and stats["buckets"] == [[64, 64]]
    metrics = str(r0["metrics"])
    assert "sshslie_requests_total 9" in metrics
    assert "sshslie_request_errors_total 3" in metrics
    assert "sshslie_reloads_total 1" in metrics
    assert not bool(r1["2/bound"])


def test_mesh_idles_past_the_group_timeout(groups):
    r0 = groups.ranks(2)[0]
    np.testing.assert_array_equal(r0["S/idle"], r0["S/reload"])


def test_shutdown_ends_every_rank(groups):
    for world, shapes in ((2, ("2",)), (4, ("4", "2x2"))):
        ranks = groups.ranks(world)     # every rank exited 0
        for shape in shapes:
            for r in ranks[1:]:
                assert bool(r[f"{shape}/left"])
    assert str(groups.ranks(2)[0]["after_shutdown"]) == "the mesh service has stopped"


def test_quantized_mesh_service_refused_on_every_rank(groups):
    for world, shapes in ((2, ("2",)), (4, ("4", "2x2"))):
        for r in groups.ranks(world):
            for shape in shapes:
                assert str(r[f"{shape}/quantize"]) == "serve_quantize is single-chip only"


def test_torchrun_serve_phase_on_a_mesh(groups):
    from sshslie_torch import serve

    cli, lines = groups.cli, []
    url = None
    deadline = time.monotonic() + RUN_TIMEOUT
    while url is None and time.monotonic() < deadline:
        line = cli.stdout.readline()
        if not line:
            break
        lines.append(line)
        m = re.search(r"Serving on http://([\d.]+):(\d+)", line)
        if m:
            url = m.groups()
    assert url is not None, "".join(lines)[-4000:]
    cube = _cube("ragged")
    blob, hd = serve.encode_cube(cube, "f32")
    conn = http.client.HTTPConnection(url[0], int(url[1]), timeout=60)
    conn.request("POST", "/enhance?encoding=f32", body=blob, headers=hd)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    assert resp.status == 200, data[:300]
    _close(serve.decode_cube_response(data, resp.headers), _one_device(groups.sd).enhance(cube)["S"],
           "the CLI's mesh service against the one-device service")
    # Ctrl-C's signal to torchrun, which sends SIGTERM to both ranks: each
    # stops cleanly.
    t = time.monotonic()
    os.killpg(cli.pid, signal.SIGINT)
    rest = cli.communicate(timeout=60)[0]
    took = time.monotonic() - t
    log = "".join(lines) + rest
    assert "Rank 1 follows rank 0's commands" in log
    assert "Stopping: rank 0 stops the other ranks" in log
    assert log.count("Job finished...") == 2, log[-4000:]
    assert took < 30, took


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
