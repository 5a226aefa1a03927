"""Guards of the port: it imports nothing of JAX or of the JAX package, and it
never runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sshslie_tpu", "ml_dtypes")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "sshslie_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_sources_exist():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"chip_smoke.py", "sshslie_torch/runner.py", "sshslie_torch/observability.py",
            "sshslie_torch/serve.py", "sshslie_torch/ops/quant.py"} <= names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_pulls_in_no_jax_and_builds_nothing():
    # Only what the port's import adds counts: an interpreter's startup hooks
    # may load modules of their own before it. matplotlib is blocked: the
    # card's machine may not have it, and only a plot that renders imports it.
    code = ("import sys\nbefore = set(sys.modules)\nsys.modules['matplotlib'] = None\n"
            "import sshslie_torch, sshslie_torch.runner, sshslie_torch.evaluate, "
            "sshslie_torch.interop, sshslie_torch.models.enhance, sshslie_torch.ops.conv9, "
            "sshslie_torch.ops.attention, sshslie_torch.ops.losses, sshslie_torch.train, "
            "sshslie_torch.observability, sshslie_torch.metrics, sshslie_torch.checkpoints, "
            "sshslie_torch.serve, sshslie_torch.ops.quant\n"
            f"bad = [m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "built = list(sshslie_torch.ops._build._libs)\n"
            "print(bad, built); sys.exit(1 if bad or built else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_point_raises_without_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    from sshslie_torch import runner
    from sshslie_torch.config import load_config
    from sshslie_torch.device import resolve_device

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(None, {"phase": "test", "channels": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(cfg)
    for spelling in (None, "", "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(spelling)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


@pytest.mark.parametrize("phase,unported", [
    ("train", {"fused_window": 2}),
    ("train_and_test", {"matmul_precision": "tensorfloat32"}),
    ("serve", {"mesh_shape": "2"}),
], ids=["train", "train_and_test", "serve"])
def test_unported_phases_raise(tmp_path, monkeypatch, phase, unported):
    """Every phase is ported, and raises for what of it is not (the rotating
    cube window, matmuls below full float32, serving on a mesh), before any
    work."""
    from sshslie_torch import runner
    from sshslie_torch.config import load_config

    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        runner.main(load_config(None, {"phase": phase, "device": "cpu", **unported}))
    assert not os.path.exists(tmp_path / "logs")


def test_chip_smoke_fails_without_card(tmp_path):
    """Without a card the smoke exits non-zero and prints no result line; alone
    in a directory (without the package) it fails too."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        script = os.path.join(cwd, "chip_smoke.py")
        proc = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                              timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
