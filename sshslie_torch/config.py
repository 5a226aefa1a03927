"""Config and flags of the port: the JAX package's keys, the port's own values.

The port's copy of ``sshslie_tpu/config.py``: the same ``Config`` fields
(every ``config/*.yml`` loads), the same precedence CLI > YAML > defaults,
the same enum checks and the same derived run directories. It differs in:

* ``conv_impl``: ``auto | torch | kernel``. 'kernel' sends the shallow conv to
  the CUDA kernel (``ops/conv9.py``), 'torch' to ``F.conv2d``, 'auto' means
  'kernel' on CUDA. The JAX values map on: ``xla`` -> torch,
  ``pallas``/``pallas_dgrad`` -> kernel.
* ``attention_impl``: ``auto | dense | chunked | kernel``; JAX ``xla`` ->
  dense, ``pallas`` -> kernel.
* ``device``: '' (the card) | cuda | gpu | cpu. Nothing runs on the CPU unless
  it is asked for.
* ``matmul_precision``: JAX's meaning of ``jax_default_matmul_precision``
  on an NVIDIA GPU (:func:`matmul_tf32`): ``default``, ``bfloat16``, ``high``
  and ``tensorfloat32`` run the float32 convolutions and matrix products in
  TF32 on the card (cuDNN and cuBLAS by their switches, the conv9 kernels
  by their TF32 entries), ``float32`` and ``highest`` in full float32. ''
  is full float32 too, where JAX's '' is the backend's default. On the CPU
  everything stays float32, as XLA's CPU backend ignores the value.
* Checkpoints are the reference ``.pth`` files (``checkpoints.py``).
* PyYAML is imported only when a YAML file is read.
* Training takes the JAX pipelines: ``fused_pipeline: auto|on`` crops and
  augments on the device from a stack of same-shape cubes (``auto`` falls
  back to the host ``PatchSampler``, numpy PCG64, on mixed shapes; ``on``
  raises there), with ``steps_per_dispatch`` steps a host call;
  ``grad_accum_steps`` splits each batch of the host pipeline into
  micro-batches. The fused pipeline's random stream is the port's own (see
  ``train.py``), not JAX's threefry. ``precision: bfloat16`` and ``remat``
  are the JAX semantics (``models/``).

``phase: serve`` and its ``serve_*`` keys are the JAX package's
(``serve.py``, ``ops/quant.py``).

The engine keys are the JAX package's: ``async_eval`` (the eval on a worker
thread and a side stream, from a snapshot of the weights), ``checkpoint_best``,
``checkpoint_async`` (the background checkpoint writer), ``use_mlflow``
(mlflow, else the file tracker under ``runs/``), ``plot_every_epoch``,
``profile_dir`` (a ``torch.profiler`` Chrome trace of the first trained
epoch) and ``eval_metric_source``.

``mesh_shape: "N"`` is data parallelism over a ``torch.distributed`` group
of N processes, one per GPU (``parallel/``; ``torchrun --nproc_per_node N``);
``mesh_shape: "DxS"`` with ``space_axis`` also splits the patch height over
S of them (dp×sp). ``eval_sharded`` splits the eval and test forwards'
height (``eval_shard_mode: spatial``, ``evaluate.py::ShardedInferencer``)
or bands (``band``, ``BandShardedInferencer``) across the data axis.
``device`` also takes 'cuda:N', a card named explicitly.

Every key loads. A value that asks for behaviour the port lacks raises
``NotImplementedError`` naming its ROADMAP.md item (:func:`check_ported`):
serving on a mesh. Keys that only change speed (``jit_cache_dir``) are
ignored, and training prints them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
from datetime import datetime
from typing import Any, Optional


def _latest_run_timestamp(model_ckpt_dir: str) -> str:
    """Newest ``Decomposition_<ts>`` run under ``model_ckpt_dir`` holding a
    ``model_epoch_latest.pth`` ('' when none exists)."""
    from glob import glob

    scan = os.path.join(model_ckpt_dir, "Decomposition_*", "model_epoch_latest.pth")
    candidates = []
    for ck in glob(scan):
        ts = os.path.basename(os.path.dirname(ck))[len("Decomposition_"):]
        candidates.append((os.path.getmtime(ck), ts))
    if not candidates:
        print(f"resume: no resumable checkpoint found (scanned "
              f"{os.path.abspath(scan)}); starting a new run")
        return ""
    return max(candidates)[1]


@dataclasses.dataclass
class Config:
    """All run configuration. Field names match the reference YAML keys."""

    # --- reference keys, same names & defaults ---
    use_gpu: int = 1                      # kept for YAML compat; ignored (see `device`)
    seed_value: int = 41
    gpu_idx: str = "0"                    # kept for YAML compat; ignored
    gpu_mem: float = 0.8                  # kept for YAML compat; ignored
    decom: int = 0
    mat_key: str = "data"
    channels: Optional[int] = 64
    global_min: float = 0.0
    global_max: float = 1.0
    normalization: str = "global_normalization"
    batch_size: int = 1
    patch_size: int = 128
    start_lr: float = 0.001
    lr_update_factor: float = 1.0
    lr_update_period: int = 400
    train_data: str = "./data/train/low"
    eval_data: str = "./data/eval/low"
    test_data: str = "./data/test/low"
    label_dir: str = "./data/test/high"
    phase: str = "train_and_test"
    epoch: int = 400
    eval_every_epoch: int = 200
    plot_every_epoch: int = 200
    c_loss_reconstruction: float = 10.0
    c_loss_r_fidelity: float = 1.0
    c_loss_i_smooth_low: float = 1.0
    c_loss_i_smooth_delta: float = 20.0
    c_loss_fourier: float = 0.2
    c_loss_spectral_cons: float = 1.0
    alpha_i_smooth_low: float = 1.0
    alpha_i_smooth_delta: float = 10.0
    save_reflectance: bool = False
    save_illumination: bool = False
    save_i_delta: bool = False
    model_name: str = "no_name_model"
    pretrained_model: str = ""
    freeze_decom_epochs: int = 0
    resume: bool = False

    # --- framework keys ---
    device: str = ""                      # '' = the CUDA card (of this rank); 'cuda:N'; 'cpu' only when asked for
    test_timestamp: str = ""              # timestamp of the checkpoint to test
    mat_key_prediction: str = "data"      # key used when reading predictions back for metrics
    precision: str = "float32"            # 'float32' | 'bfloat16': the layers' compute dtype
    matmul_precision: str = ""            # '' | 'float32' | 'highest': full float32; else TF32 on the card
    attention_impl: str = "auto"          # 'auto' | 'dense' | 'chunked' | 'kernel'
    conv_impl: str = "auto"               # 'auto' | 'torch' | 'kernel': the shallow conv's path
    remat: bool = False                   # recompute each sub-network's activations in the backward
    use_attention: bool = False           # SEBlock variant (reference model.py:122,130-131)
    use_transformer: bool = True          # TransformerBlock variant (reference default)
    mesh_shape: str = ""                  # "N" or "DxS": one process a GPU (torchrun)
    data_axis: str = "data"               # the mesh's data axis name
    space_axis: str = ""                  # dp x sp: the 2-D mesh's axis the patch height splits on
    prefetch_batches: int = 2             # host pipeline: batches staged ahead on a worker thread
    data_pattern: str = "*.mat"           # dataset glob per split dir
    lazy_loading: bool = False            # true: the disk-backed LazyCubeStore (an LRU cache)
    cube_cache_size: int = 8              # cubes the LazyCubeStore keeps in RAM
    fused_pipeline: str = "auto"          # 'auto' | 'on' | 'off': on-device crop + augment
    sampler: str = "auto"                 # 'auto': native if it loads; 'native'; 'python': PatchSampler
    steps_per_dispatch: int = 1           # fused steps a host call
    fused_window: Any = 0                 # fused pipeline: K cubes on the device an epoch; 'auto' sizes K
    grad_accum_steps: int = 1             # micro-batches a step (host pipeline)
    log_every_step: int = 0               # >0: print the loss every N batches
    checkpoint_keep: int = 0              # >0: keep only the newest N model_epoch_N.pth
    checkpoint_best: bool = False         # true: copy the best-eval-PSNR epoch to model_epoch_best
    use_mlflow: bool = True               # mlflow if it imports, else runs/<experiment>/ files
    jit_cache_dir: str = "~/.cache/sshslie_tpu/xla"  # JAX key; speed only, ignored
    profile_dir: str = ""                 # non-empty: torch.profiler trace of the first epoch
    eval_pad_multiple: int = 1            # >1: edge-pad H,W to a multiple before the forward
    eval_batch: int = 1                   # >1: stack same-shape cubes into one forward
    eval_sharded: bool = False            # with a mesh: eval/test forwards sharded over the ranks
    eval_shard_mode: str = "spatial"      # 'spatial' (height) | 'band' (spectral)
    async_eval: bool = False              # true: evals on a worker thread and a side stream
    eval_metric_source: str = "memory"    # 'memory' | 'disk': score S in memory or the saved files
    checkpoint_async: bool = True         # write checkpoints on a background thread
    serve_host: str = "127.0.0.1"         # phase=serve: bind address
    serve_port: int = 8900                # phase=serve: port (0 = a free one)
    serve_pad_multiple: int = 64          # phase=serve: shape-bucket granularity
    serve_warmup: str = ""                # phase=serve: buckets run at start, e.g. '512x512,1024x1024'
    serve_max_batch: int = 1              # phase=serve: coalesce concurrent same-bucket requests (1 = off)
    serve_quantize: str = ""              # phase=serve: ''|'int8'|'fp8'|'int4' weight-only quantized serving
    serve_reload_token: str = ""          # phase=serve: required (X-Reload-Token) to reload a given path
    serve_batch_window_ms: float = 5.0    # phase=serve: batching window after the first pending request

    # --- derived (filled by finalize(); do not set in YAML) ---
    timestamp: str = ""
    full_model_name: str = ""
    model_ckpt_dir: str = ""
    eval_result_dir: str = ""
    test_result_dir: str = ""
    test_model_dir: str = ""
    log_file_path: str = ""
    config_path: str = ""

    def finalize(self, now: Optional[datetime] = None) -> "Config":
        """Derive run names and directories (reference main.py:76-88)."""
        now = now or datetime.now()
        if not self.timestamp:
            self.timestamp = f"{now:%Y%m%d_%H%M%S}"
        self.model_ckpt_dir = os.path.join(".", "checkpoint", self.model_name)
        postfix = ""
        if self.phase in ("test", "serve"):
            postfix = "_test_" + self.timestamp
            if self.test_timestamp:
                self.timestamp = self.test_timestamp
        elif self.resume:
            ts = self.test_timestamp or _latest_run_timestamp(self.model_ckpt_dir)
            if ts:
                self.timestamp = ts
        self.full_model_name = f"{self.model_name}_{self.timestamp}{postfix}"
        self.eval_result_dir = os.path.join(".", "results", "eval_results_" + self.full_model_name)
        self.test_result_dir = os.path.join(".", "results", "test_results_" + self.full_model_name)
        self.test_model_dir = os.path.join(
            ".", "checkpoint", self.model_name, "Decomposition_" + self.timestamp
        )
        self.log_file_path = os.path.join(".", "logs", self.full_model_name + ".log")
        return self

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_DERIVED_FIELDS = {
    "timestamp", "full_model_name", "model_ckpt_dir", "eval_result_dir",
    "test_result_dir", "test_model_dir", "log_file_path", "config_path",
}

_ENUM_FIELDS: dict[str, tuple] = {
    "phase": ("train", "test", "train_and_test", "serve"),
    "normalization": ("self", "global_normalization",
                      "per_channel_normalization",
                      "per_channel_standardization", None, ""),
    "precision": ("float32", "bfloat16"),
    "matmul_precision": ("", "default", "bfloat16", "high",
                         "tensorfloat32", "float32", "highest"),
    "attention_impl": ("auto", "dense", "chunked", "kernel"),
    "conv_impl": ("auto", "torch", "kernel"),
    "sampler": ("auto", "native", "python"),
    "fused_pipeline": ("auto", "on", "off"),
    "serve_quantize": ("", "int8", "fp8", "int4"),
    "eval_shard_mode": ("spatial", "band"),
    "eval_metric_source": ("memory", "disk"),
    "device": ("", "cuda", "gpu", "cpu"),
}

# JAX values of the kernel switches, mapped onto the port's.
_IMPL_ALIASES: dict[str, dict[str, str]] = {
    "conv_impl": {"xla": "torch", "pallas": "kernel", "pallas_dgrad": "kernel"},
    "attention_impl": {"xla": "dense", "pallas": "kernel"},
}

_INT_OR_AUTO_FIELDS = ("fused_window",)

_POSITIVE_INT_FIELDS = (
    "batch_size", "patch_size", "epoch", "eval_every_epoch",
    "plot_every_epoch",
)


def _validate_enums(cfg: "Config") -> None:
    for key, aliases in _IMPL_ALIASES.items():
        val = getattr(cfg, key)
        setattr(cfg, key, aliases.get(val, val))
    for key, choices in _ENUM_FIELDS.items():
        val = getattr(cfg, key)
        if key == "device" and isinstance(val, str) and re.fullmatch(r"cuda:\d+", val):
            continue
        if val not in choices:
            shown = [c for c in choices if c not in (None, "")]
            raise ValueError(
                f"config key {key!r}: invalid value {val!r} "
                f"(choices: {', '.join(map(str, shown))})"
            )
    for key in _INT_OR_AUTO_FIELDS:
        val = getattr(cfg, key)
        if isinstance(val, str):
            if val.strip().lower() == "auto":
                setattr(cfg, key, "auto")
                continue
            try:
                val = int(val)
            except ValueError:
                raise ValueError(
                    f"config key {key!r}: invalid value {val!r} "
                    "(an integer >= 0, or 'auto')"
                )
            setattr(cfg, key, val)
        if isinstance(val, bool) or not isinstance(val, int) or val < 0:
            raise ValueError(
                f"config key {key!r}: invalid value {val!r} "
                "(an integer >= 0, or 'auto')"
            )
    for key in _POSITIVE_INT_FIELDS:
        val = getattr(cfg, key)
        if isinstance(val, bool) or not isinstance(val, int) or val < 1:
            raise ValueError(
                f"config key {key!r}: invalid value {val!r} "
                "(an integer >= 1)"
            )


# matmul_precision values that run float32 products in TF32 on the card: the
# TF32 passes XLA takes for them on an NVIDIA GPU (float32 accumulation).
TF32_PRECISIONS = ("default", "bfloat16", "high", "tensorfloat32")


def matmul_tf32(matmul_precision: str) -> bool:
    """Does this ``matmul_precision`` run float32 products in TF32 on the
    card? True for default, bfloat16, high and tensorfloat32; False for
    float32, highest and '' (the port's full float32)."""
    if matmul_precision not in _ENUM_FIELDS["matmul_precision"]:
        raise ValueError(f"matmul_precision: invalid value {matmul_precision!r}")
    return matmul_precision in TF32_PRECISIONS


# Training keys that change only speed; training prints them as ignored.
SPEED_ONLY_KEYS = ("jit_cache_dir",)


def check_ported(cfg: "Config", serving: bool = False) -> None:
    """Raise NotImplementedError for a value whose behaviour the port lacks, so
    that no ignored key changes results: a mesh when ``serving`` (or
    ``phase: serve``). Serving on a mesh is item 7's last part."""
    if (serving or cfg.phase == "serve") and cfg.mesh_shape:
        raise NotImplementedError("serving on a mesh (mesh_shape) is not ported yet "
                                  "(ROADMAP.md queue 1, item 7: serving)")


def _coerce(value: str, target_type: type) -> Any:
    """Parse a CLI string into the dataclass field's type."""
    if target_type is bool:
        return value.lower() in ("1", "true", "yes", "y", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def load_config(
    yaml_path: Optional[str] = None,
    overrides: Optional[dict[str, Any]] = None,
    finalize: bool = True,
) -> Config:
    """Build a Config with precedence overrides (CLI) > YAML > defaults.

    Unknown keys raise, as in the JAX package.
    """
    cfg = Config()
    known = {f.name for f in dataclasses.fields(Config)}
    if yaml_path:
        import yaml

        with open(yaml_path, "r") as fh:
            data = yaml.safe_load(fh) or {}
        for key, val in data.items():
            if key not in known:
                raise KeyError(f"Unknown config key in {yaml_path}: {key!r}")
            if key in _DERIVED_FIELDS:
                raise KeyError(f"Config key {key!r} is derived and cannot be set in YAML")
            setattr(cfg, key, val)
        cfg.config_path = yaml_path
    for key, val in (overrides or {}).items():
        if val is None:
            continue
        if key not in known:
            raise KeyError(f"Unknown config override: {key!r}")
        setattr(cfg, key, val)
    _validate_enums(cfg)
    if finalize:
        cfg.finalize()
    return cfg


def parse_args(argv: Optional[list[str]] = None) -> Config:
    """CLI entry: ``python -m sshslie_torch --config config/*.yml [--key val ...]``.

    Every config key is a typed ``--key`` flag whose presence overrides the YAML.
    """
    parser = argparse.ArgumentParser(
        description="SS-HSLIE on PyTorch/CUDA: parse config from YAML and command line."
    )
    parser.add_argument("--config", type=str, default="./config/config.yml")
    defaults = Config()
    field_types: dict[str, type] = {}
    for field in dataclasses.fields(Config):
        if field.name in _DERIVED_FIELDS:
            continue
        default_val = getattr(defaults, field.name)
        ftype = int if default_val is None else type(default_val)
        parser.add_argument(f"--{field.name}", type=str, default=None)
        field_types[field.name] = ftype
    args = parser.parse_args(argv)

    overrides: dict[str, Any] = {}
    for name, ftype in field_types.items():
        val = getattr(args, name)
        if val is None:
            continue
        if name in _INT_OR_AUTO_FIELDS:
            overrides[name] = val
        else:
            overrides[name] = _coerce(val, ftype)
    return load_config(args.config, overrides)
