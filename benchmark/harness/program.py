"""What the harness hands the program: its Config, built from a cell's
configuration file (the keys the program knows; the file's other keys,
such as ``source`` or ``assumed``, are the benchmark's), and the launch
counters it reads back."""

from __future__ import annotations

import dataclasses


def config(cell_config: dict, **overrides):
    from sshslie_torch.config import Config, load_config

    known = {f.name for f in dataclasses.fields(Config)}
    keys = {k: v for k, v in cell_config.items() if k in known}
    return load_config(None, {**keys, **overrides}, finalize=False)


def reset_launches() -> None:
    from sshslie_torch.ops import attention, conv9

    conv9.reset_counts()
    attention.reset_counts()


def launches() -> dict:
    """{"conv9" | "wgrad" | "flash": {(pass, label, shape): count}} since the
    last reset."""
    from sshslie_torch.ops import attention, conv9

    return {"conv9": dict(conv9.conv9_fwd.launches_by_shape),
            "wgrad": dict(conv9.conv9_wgrad.launches_by_shape),
            "flash": dict(attention.flash_attention.launches_by_shape)}
