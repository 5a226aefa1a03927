"""HSI cube I/O and normalisation (host side, numpy/scipy), as
``sshslie_tpu/utils/io_hsi.py``.

* :func:`load_hsi` reads an (H, W, C) float32 cube from a ``.mat`` file: v7
  through scipy, MATLAB v7.3 (HDF5) through h5py, imported only then. The
  four normalisations, the clamp of negatives after global normalisation
  and the divide-by-own-max quirk (reference utils.py:36-57, PARITY #1) are
  kept, since the published results depend on them.
* :func:`save_hsi` writes atomically (temp file + rename), v7.3 past scipy's
  2**31-byte limit.
* :func:`load_hsi_bytes` parses an in-memory ``.mat`` payload (the serving
  path's request bodies) and :func:`normalize_like_load_torch` is
  :func:`normalize_like_load` on a tensor, for the serving path's
  device-side decode.

ENVI ``.hdr`` input is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import scipy.io as sio
import torch


def _load_mat_v73(file: str, mat_key: str) -> np.ndarray:
    """One variable of a MATLAB v7.3 (HDF5) file; h5py shows MATLAB's
    column-major axes reversed, so they are reversed back."""
    import h5py

    with h5py.File(file, "r") as fh:
        if mat_key not in fh:
            raise KeyError(
                f"{file}: variable {mat_key!r} not found; available: "
                f"{[k for k in fh.keys() if not k.startswith('#')]}"
            )
        arr = np.asarray(fh[mat_key])
    return arr.transpose(tuple(reversed(range(arr.ndim))))


def _save_mat_v73(out: str, data: np.ndarray, key: str) -> None:
    """A v7.3 .mat: HDF5 with MATLAB's 512-byte header, reversed axes and the
    MATLAB_class attribute."""
    import h5py

    with h5py.File(out, "w", userblock_size=512) as fh:
        dset = fh.create_dataset(key, data=data.transpose(tuple(reversed(range(data.ndim)))))
        if data.dtype.kind == "f":
            kind = "double" if data.dtype.itemsize == 8 else "single"
        elif data.dtype.kind in ("i", "u"):
            kind = f"{'u' if data.dtype.kind == 'u' else ''}int{data.dtype.itemsize * 8}"
        else:
            kind = "double"
        dset.attrs["MATLAB_class"] = np.bytes_(kind)
    header = b"MATLAB 7.3 MAT-file, written by sshslie_torch; HDF5-based format"
    header = header.ljust(116) + b"\x00" * 8 + b"\x00\x02" + b"IM"
    with open(out, "r+b") as fh:
        fh.write(header)


def load_hsi(
    file: str,
    mat_key: str = "data",
    normalization: Optional[str] = None,
    max_val: Optional[float] = None,
    min_val: Optional[float] = None,
    rescale_by_max: bool = True,
) -> np.ndarray:
    """Load an (H, W, C) float32 cube from a ``.mat`` file and normalise it."""
    if file.lower().endswith(".hdr"):
        raise NotImplementedError(
            f"{file}: ENVI input is not ported yet (ROADMAP.md queue 1, item 9)")
    try:
        mat = sio.loadmat(file)
    except (NotImplementedError, ValueError):
        # scipy refuses v7.3 (HDF5) files; read those with h5py.
        import h5py

        if not h5py.is_hdf5(file):
            raise
        mat = {mat_key: _load_mat_v73(file, mat_key)}
    if mat_key not in mat:
        raise KeyError(
            f"{file}: variable {mat_key!r} not found; available: "
            f"{[k for k in mat if not k.startswith('__')]}"
        )
    x = np.asarray(mat[mat_key], dtype=np.float32)
    return normalize_like_load(x, normalization, max_val=max_val, min_val=min_val,
                               rescale_by_max=rescale_by_max)


def normalize_like_load(
    x: np.ndarray,
    normalization: Optional[str],
    max_val: Optional[float] = None,
    min_val: Optional[float] = None,
    rescale_by_max: bool = True,
) -> np.ndarray:
    """``load_hsi``'s normalisation of an in-memory cube."""
    if normalization is None or normalization == "":
        return x
    if normalization == "self":
        x = self_normalization(x)
    elif normalization == "global_normalization":
        x = global_normalization(x, max_val=max_val, min_val=min_val)
        x[x < 0] = 0.0
    elif normalization == "per_channel_normalization":
        x = per_channel_normalization(x)
    elif normalization == "per_channel_standardization":
        x = per_channel_standardization(x)
    else:
        raise NotImplementedError(f"{normalization} is not implemented")
    x = x.astype(np.float32)
    if rescale_by_max:
        # Reference quirk (utils.py:57): every normalised cube is then divided
        # by its own max.
        x = x / np.max(x)
    return x


# HDF5 file signature (the v7.3 .mat container). h5py.is_hdf5 takes only
# paths, so in-memory dispatch checks the magic directly.
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def load_hsi_bytes(body: bytes, mat_key: str = "data") -> np.ndarray:
    """Parse an in-memory ``.mat`` payload (v7 through scipy, v7.3 through
    h5py on a BytesIO), without normalisation.

    The bytes come from the wire: every malformed payload raises ValueError
    (an HTTP 400 in ``serve.py``), never a scipy or h5py exception type. A
    missing variable stays a KeyError (also a 400), naming the keys there."""
    import io

    try:
        mat = sio.loadmat(io.BytesIO(body))
    except Exception as e:  # scipy raises several types on crafted input
        if body[: len(_HDF5_MAGIC)] == _HDF5_MAGIC:
            try:
                return np.asarray(_load_mat_v73(io.BytesIO(body), mat_key), dtype=np.float32)
            except KeyError:
                raise
            except Exception as e73:  # truncated or crafted HDF5
                raise ValueError(f"unreadable v7.3 .mat payload ({type(e73).__name__}: {e73})")
        raise ValueError(f"body is not a readable .mat payload ({type(e).__name__}: {e})")
    if mat_key not in mat:
        raise KeyError(
            f"variable {mat_key!r} not found; available: "
            f"{[k for k in mat if not k.startswith('__')]}"
        )
    try:
        return np.asarray(mat[mat_key], dtype=np.float32)
    except (TypeError, ValueError) as e:
        # MATLAB cell, object and char variables are not numeric cubes.
        raise ValueError(f"variable {mat_key!r} is not a numeric cube ({type(e).__name__}: {e})")


def normalize_like_load_torch(
    x: torch.Tensor,
    normalization: Optional[str],
    max_val: Optional[float] = None,
    min_val: Optional[float] = None,
    rescale_by_max: bool = True,
) -> torch.Tensor:
    """:func:`normalize_like_load` on a float32 (H, W, C) tensor, on its
    device: the serving path uploads a request's 2-byte payload as it is and
    decodes and normalises it on the card. The same float32 operations in
    the same order, the clamp after global normalisation and the
    divide-by-own-max quirk included.

    'self', 'global_normalization' and 'per_channel_normalization' give the
    same result on an edge-padded cube (a replicated value is no new
    extremum); 'per_channel_standardization' does not (the mean and std
    move), so a caller that pads first must normalise that mode on the host."""
    if normalization is None or normalization == "":
        return x
    if normalization == "self":
        x = x / torch.max(x)
    elif normalization == "global_normalization":
        if max_val is None:
            raise ValueError("max value is not provided for global normalization")
        lo = 0.0 if min_val is None else min_val
        if lo > max_val:
            raise ValueError("min value cannot be larger than the max value")
        x = (x - lo) / (max_val - lo)
        x = torch.clamp_min(x, 0.0)
    elif normalization == "per_channel_normalization":
        min_vals = torch.amin(x, dim=(0, 1), keepdim=True)
        max_vals = torch.amax(x, dim=(0, 1), keepdim=True)
        range_vals = torch.where(max_vals > min_vals, max_vals - min_vals, 1.0)
        x = (x - min_vals) / range_vals
    elif normalization == "per_channel_standardization":
        mean_vals = torch.mean(x, dim=(0, 1), keepdim=True)
        std_vals = torch.std(x, dim=(0, 1), keepdim=True, correction=0)
        std_vals = torch.where(std_vals > 0, std_vals, 1.0)
        x = (x - mean_vals) / std_vals
    else:
        raise NotImplementedError(f"{normalization} is not implemented")
    x = x.float()
    if rescale_by_max:
        x = x / torch.max(x)
    return x


def save_hsi(filepath: str, data: np.ndarray, key: str = "data", fmt: str = "auto") -> str:
    """Save an (H, W, C) cube to ``<filepath without extension>.mat`` under
    ``key``; returns the path written. ``fmt``: 'v7', 'v7.3' or 'auto'."""
    out = os.path.splitext(filepath)[0] + ".mat"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    data = np.asarray(data)
    if fmt == "auto":
        fmt = "v7.3" if data.nbytes >= 2**31 else "v7"
    tmp = out + ".tmp"
    try:
        if fmt == "v7.3":
            _save_mat_v73(tmp, data, key)
        elif fmt == "v7":
            sio.savemat(tmp, {key: data}, appendmat=False)
        else:
            raise ValueError(f"unknown .mat format {fmt!r} (use 'v7', 'v7.3', 'auto')")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


# --- normalisation modes (reference utils.py:59-109) ---

def self_normalization(x: np.ndarray) -> np.ndarray:
    return x / np.max(x)


def global_normalization(x: np.ndarray, max_val: Optional[float] = None,
                         min_val: Optional[float] = None) -> np.ndarray:
    """(x - min) / (max - min) with dataset-global bounds."""
    if max_val is None:
        raise ValueError("max value is not provided for global normalization")
    if min_val is None:
        min_val = 0.0
    if min_val > max_val:
        raise ValueError("min value cannot be larger than the max value")
    return (x - min_val) / (max_val - min_val)


def per_channel_normalization(x: np.ndarray) -> np.ndarray:
    min_vals = np.min(x, axis=(0, 1), keepdims=True)
    max_vals = np.max(x, axis=(0, 1), keepdims=True)
    range_vals = np.where(max_vals > min_vals, max_vals - min_vals, 1.0)
    return (x - min_vals) / range_vals


def per_channel_standardization(x: np.ndarray) -> np.ndarray:
    mean_vals = np.mean(x, axis=(0, 1), keepdims=True)
    std_vals = np.std(x, axis=(0, 1), keepdims=True)
    std_vals = np.where(std_vals > 0, std_vals, 1.0)
    return (x - mean_vals) / std_vals
