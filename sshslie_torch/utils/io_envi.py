"""ENVI hyperspectral I/O (a ``.hdr`` text header beside a raw binary file),
as ``sshslie_tpu/utils/io_envi.py``; numpy only.

The reference reads ``.mat`` cubes only; ENVI pairs are how many
pushbroom cameras ship their captures. The subset read and written here:

* header fields samples / lines / bands / data type / interleave / byte
  order / header offset, and an optional wavelength list;
* data types 1 (u8), 2 (i16), 3 (i32), 4 (f32), 5 (f64), 12 (u16);
* interleaves BSQ, BIL and BIP, and both byte orders.

``utils/io_hsi.py::load_hsi`` takes ``.hdr`` paths here, so every surface
that reads a cube path (the stores through ``data_pattern``, the viz,
inspect, align and metrics tools) reads ENVI too. A cube comes out as a
(lines, samples, bands) float32 array, the (H, W, C) of a ``.mat`` cube.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# ENVI "data type" codes → numpy dtypes (interchange subset).
_DTYPES = {
    1: np.uint8,
    2: np.int16,
    3: np.int32,
    4: np.float32,
    5: np.float64,
    12: np.uint16,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_envi_header(hdr_path: str) -> Dict[str, object]:
    """Parse an ENVI ``.hdr`` into a flat dict (keys lowercased).

    Handles ``key = value`` lines and ``key = { multi, line, lists }``;
    list values are returned as lists of stripped strings.

    The parser is a line scanner, not a regex over the whole text: a
    ``key = {`` opener consumes lines until the closing ``}`` and *rejects*
    the header if non-whitespace trails the brace on the closing line —
    otherwise prose leaking out of a truncated block could be re-parsed as
    ``key = value`` lines and silently shadow real fields.
    ENVI blocks do not nest, so the first ``}`` terminates a block.
    """
    with open(hdr_path, "r", errors="replace") as fh:
        text = fh.read()
    if not text.lstrip().upper().startswith("ENVI"):
        raise ValueError(f"{hdr_path}: missing ENVI header magic")
    fields: Dict[str, object] = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        m = re.match(r"^\s*([^={}]+?)\s*=\s*(.*)$", lines[i])
        if not m:
            i += 1
            continue
        key = m.group(1).strip().lower()
        val = m.group(2).strip()
        if val.startswith("{"):
            block = val[1:]
            while "}" not in block:
                i += 1
                if i >= len(lines):
                    raise ValueError(
                        f"{hdr_path}: unterminated '{{' block for field "
                        f"{key!r}"
                    )
                block += "\n" + lines[i]
            body, _, rest = block.partition("}")
            if rest.strip():
                raise ValueError(
                    f"{hdr_path}: trailing content after '}}' closing field "
                    f"{key!r}: {rest.strip()!r}"
                )
            fields.setdefault(
                key, [v.strip() for v in body.split(",") if v.strip()]
            )
        elif val:
            fields.setdefault(key, val)
        i += 1
    return fields


def _data_path_for(hdr_path: str) -> str:
    """The raw-binary companion of a ``.hdr``: same basename with its own
    extension stripped, tried bare and with the common suffixes."""
    base = os.path.splitext(hdr_path)[0]
    candidates = [base] + [base + ext for ext in (".img", ".dat", ".raw", ".bsq", ".bil", ".bip")]
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"no ENVI data file next to {hdr_path} (tried {candidates})"
    )


def load_envi(hdr_path: str) -> np.ndarray:
    """Read an ENVI pair into an (lines, samples, bands) float32 cube."""
    h = read_envi_header(hdr_path)
    try:
        samples = int(str(h["samples"]))
        lines = int(str(h["lines"]))
        bands = int(str(h["bands"]))
        dcode = int(str(h["data type"]))
    except KeyError as e:
        raise ValueError(f"{hdr_path}: missing required ENVI field {e}")
    if dcode not in _DTYPES:
        raise ValueError(
            f"{hdr_path}: unsupported ENVI data type {dcode} "
            f"(supported: {sorted(_DTYPES)})"
        )
    interleave = str(h.get("interleave", "bsq")).strip().lower()
    offset = int(str(h.get("header offset", 0)))
    byte_order = int(str(h.get("byte order", 0)))
    dtype = np.dtype(_DTYPES[dcode]).newbyteorder("<" if byte_order == 0 else ">")

    raw = np.fromfile(_data_path_for(hdr_path), dtype=dtype, offset=offset,
                      count=samples * lines * bands)
    if raw.size != samples * lines * bands:
        raise ValueError(
            f"{hdr_path}: data file holds {raw.size} values, header promises "
            f"{samples * lines * bands} ({lines}x{samples}x{bands})"
        )
    if interleave == "bsq":      # (bands, lines, samples)
        cube = raw.reshape(bands, lines, samples).transpose(1, 2, 0)
    elif interleave == "bil":    # (lines, bands, samples)
        cube = raw.reshape(lines, bands, samples).transpose(0, 2, 1)
    elif interleave == "bip":    # (lines, samples, bands)
        cube = raw.reshape(lines, samples, bands)
    else:
        raise ValueError(f"{hdr_path}: unknown interleave {interleave!r}")
    return np.ascontiguousarray(cube, dtype=np.float32)


def envi_wavelengths(hdr_path: str) -> Optional[List[float]]:
    """The header's per-band wavelengths (nm), or None when absent."""
    h = read_envi_header(hdr_path)
    wl = h.get("wavelength")
    if not isinstance(wl, list):
        return None
    try:
        return [float(w) for w in wl]
    except ValueError:
        return None


def save_envi(
    path: str,
    cube: np.ndarray,
    interleave: str = "bsq",
    wavelengths: Optional[List[float]] = None,
    dtype: np.dtype = np.float32,
) -> Tuple[str, str]:
    """Write an (H, W, C) cube as an ENVI pair; returns (hdr, data) paths.

    Atomic like :func:`save_hsi` (tmp + rename per file). Both tmp files are
    fully written before either rename, and the data file is renamed BEFORE
    the header — so to readers that discover pairs via the ``.hdr`` (the
    ``data_pattern: "*.hdr"`` convention) a *fresh* pair appears complete or
    not at all. The two renames are still not one transaction: a crash
    between them leaves an orphaned data file without its header (invisible
    to .hdr-globbing readers, but stray bytes), and *overwriting an existing
    pair in place is not safe against a concurrent reader*, which can
    observe new data against the old header (or vice versa). Writers
    replacing live pairs should write to a fresh basename and swap a
    directory/symlink instead."""
    cube = np.asarray(cube)
    if cube.ndim != 3:
        raise ValueError(f"expected (H, W, C), got {cube.shape}")
    dtype = np.dtype(dtype)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype} for ENVI")
    interleave = interleave.lower()
    lines, samples, bands = cube.shape
    if interleave == "bsq":
        raw = cube.transpose(2, 0, 1)
    elif interleave == "bil":
        raw = cube.transpose(0, 2, 1)
    elif interleave == "bip":
        raw = cube
    else:
        raise ValueError(f"unknown interleave {interleave!r}")
    base = os.path.splitext(path)[0]
    hdr_path, data_path = base + ".hdr", base + ".img"
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    hdr_lines = [
        "ENVI",
        # The JAX package's description: both packages write the same bytes.
        "description = {sshslie_tpu export}",
        f"samples = {samples}",
        f"lines = {lines}",
        f"bands = {bands}",
        "header offset = 0",
        "file type = ENVI Standard",
        f"data type = {_DTYPE_CODES[dtype]}",
        f"interleave = {interleave}",
        "byte order = 0",
    ]
    if wavelengths is not None:
        if len(wavelengths) != bands:
            raise ValueError(
                f"{len(wavelengths)} wavelengths for {bands} bands"
            )
        hdr_lines.append(
            "wavelength = {" + ", ".join(f"{w:g}" for w in wavelengths) + "}"
        )
    def _write_hdr(p: str) -> None:
        with open(p, "w") as fh:  # explicit close → flushed before rename
            fh.write("\n".join(hdr_lines) + "\n")

    targets = (
        (data_path, lambda p: np.ascontiguousarray(
            raw, dtype=dtype.newbyteorder("<")).tofile(p)),
        (hdr_path, _write_hdr),
    )
    tmps = [t + ".tmp" for t, _ in targets]
    try:
        for (_, write), tmp in zip(targets, tmps):
            write(tmp)
        for (target, _), tmp in zip(targets, tmps):
            os.replace(tmp, target)
    finally:
        for tmp in tmps:
            if os.path.exists(tmp):
                os.remove(tmp)
    return hdr_path, data_path
