"""The port's ENVI reader and writer (``sshslie_torch/utils/io_envi.py``) and
the additions to ``utils/io_hsi.py``, against the JAX package's on the CPU.

Both are numpy only, so everything is held exactly: each case of
tests/test_io_envi.py (every data type, interleave and byte order, header
offsets, wavelength lists, the errors) through both packages; files written
by either are byte-equal and read by the other; ``load_hsi`` of a ``.hdr``
under each normalisation; a ``CubeStore`` with ``data_pattern: "*.hdr"``;
``split_cube_spec``, ``load_cube_specs``, the three inverses,
``select_hsi_wavelengths``, ``adaptive_lr`` and ``polynomial_decay``.
"""

import os

import numpy as np
import pytest

from sshslie_tpu.utils import io_envi as jax_envi
from sshslie_tpu.utils import io_hsi as jax_hsi
from sshslie_torch.utils import io_envi, io_hsi


@pytest.fixture
def cube():
    return (np.random.default_rng(11).random((5, 7, 3)) * 1000).astype(np.float32)


def _pair_bytes(hdr):
    with open(hdr, "rb") as fh:
        head = fh.read()
    with open(os.path.splitext(hdr)[0] + ".img", "rb") as fh:
        return head, fh.read()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64, np.uint16])
@pytest.mark.parametrize("interleave", ["bsq", "bil", "bip"])
def test_write_and_read_equal_jax(tmp_path, dtype, interleave):
    cube = (np.random.default_rng(3).random((4, 6, 5)) * 200).astype(dtype)
    wl = [400.0 + 10.5 * i for i in range(5)]
    ours, _ = io_envi.save_envi(str(tmp_path / "a" / "c.img"), cube, interleave=interleave,
                                wavelengths=wl, dtype=dtype)
    theirs, _ = jax_envi.save_envi(str(tmp_path / "b" / "c.img"), cube, interleave=interleave,
                                   wavelengths=wl, dtype=dtype)
    assert _pair_bytes(ours) == _pair_bytes(theirs)
    for reader in (io_envi.load_envi, jax_envi.load_envi):
        for path in (ours, theirs):
            got = reader(path)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, cube.astype(np.float32))
    assert io_envi.read_envi_header(ours) == jax_envi.read_envi_header(theirs)
    assert io_envi.envi_wavelengths(ours) == jax_envi.envi_wavelengths(theirs)


@pytest.mark.parametrize("order,dtype,code", [(1, ">f4", 4), (0, "<i2", 2), (1, ">u2", 12),
                                              (1, ">f8", 5), (0, "<i4", 3)])
def test_byte_orders_and_offsets(tmp_path, cube, order, dtype, code):
    raw = cube.transpose(2, 0, 1).astype(dtype)
    with open(tmp_path / "be.img", "wb") as fh:
        fh.write(b"\x00" * 16)
        fh.write(raw.tobytes())
    (tmp_path / "be.hdr").write_text(
        f"ENVI\nsamples = 7\nlines = 5\nbands = 3\ndata type = {code}\n"
        f"interleave = bsq\nbyte order = {order}\nheader offset = 16\n")
    got = io_envi.load_envi(str(tmp_path / "be.hdr"))
    np.testing.assert_array_equal(got, jax_envi.load_envi(str(tmp_path / "be.hdr")))
    np.testing.assert_array_equal(got, cube.astype(dtype).astype(np.float32))


def test_multiline_header_and_brace_errors(tmp_path):
    (tmp_path / "ml.hdr").write_text(
        "ENVI\nsamples = 7\nlines = 5\nbands = 3\ndata type = 4\n"
        "wavelength = {450.5,\n 550.0,\n 650.25}\n")
    h = io_envi.read_envi_header(str(tmp_path / "ml.hdr"))
    assert h == jax_envi.read_envi_header(str(tmp_path / "ml.hdr"))
    assert h["wavelength"] == ["450.5", "550.0", "650.25"]
    (tmp_path / "leak.hdr").write_text(
        "ENVI\nsamples = 4\nlines = 4\nbands = 2\ndata type = 4\n"
        "description = {note about braces} and then samples = 9999\n")
    (tmp_path / "open.hdr").write_text("ENVI\nsamples = 4\ndescription = {never closed\n")
    for name, match in (("leak.hdr", "trailing content"), ("open.hdr", "unterminated")):
        for mod in (io_envi, jax_envi):
            with pytest.raises(ValueError, match=match):
                mod.read_envi_header(str(tmp_path / name))


def test_errors_equal_jax(tmp_path, cube):
    hdr, data = io_envi.save_envi(str(tmp_path / "e"), cube)
    os.remove(data)
    hdr2, data2 = io_envi.save_envi(str(tmp_path / "t"), cube)
    with open(data2, "r+b") as fh:
        fh.truncate(10)
    (tmp_path / "u.hdr").write_text("ENVI\nsamples = 2\nlines = 2\nbands = 1\ndata type = 6\n")
    (tmp_path / "n.hdr").write_text("not a header\n")
    (tmp_path / "m.hdr").write_text("ENVI\nsamples = 2\nlines = 2\ndata type = 4\n")
    cases = ((hdr, FileNotFoundError, "no ENVI data file"),
             (hdr2, ValueError, "holds .* header promises"),
             (str(tmp_path / "u.hdr"), ValueError, "unsupported ENVI data type"),
             (str(tmp_path / "n.hdr"), ValueError, "ENVI header magic"),
             (str(tmp_path / "m.hdr"), ValueError, "missing required ENVI field"))
    for path, exc, match in cases:
        for mod in (io_envi, jax_envi):
            with pytest.raises(exc, match=match):
                mod.load_envi(path)
    for mod in (io_envi, jax_envi):
        with pytest.raises(ValueError, match="wavelengths for 3 bands"):
            mod.save_envi(str(tmp_path / "w"), cube, wavelengths=[1.0])
        with pytest.raises(ValueError, match="unknown interleave"):
            mod.save_envi(str(tmp_path / "w"), cube, interleave="bad")
        with pytest.raises(ValueError, match="unsupported dtype"):
            mod.save_envi(str(tmp_path / "w"), cube, dtype=np.int64)


@pytest.mark.parametrize("normalization,kw", [
    (None, {}), ("self", {}), ("global_normalization", {"max_val": 4095.0, "min_val": 100.0}),
    ("per_channel_normalization", {}), ("per_channel_standardization", {}),
])
def test_load_hsi_of_envi_equals_jax_and_mat(tmp_path, cube, normalization, kw):
    import scipy.io as sio

    hdr, _ = io_envi.save_envi(str(tmp_path / "n"), cube, interleave="bil")
    sio.savemat(str(tmp_path / "n.mat"), {"data": cube})
    got = io_hsi.load_hsi(hdr, normalization=normalization, **kw)
    np.testing.assert_array_equal(got, jax_hsi.load_hsi(hdr, normalization=normalization, **kw))
    from_mat = io_hsi.load_hsi(str(tmp_path / "n.mat"), normalization=normalization, **kw)
    if normalization == "per_channel_standardization":
        # loadmat's array is Fortran-ordered, the ENVI cube C-ordered: numpy's
        # mean and std sum them in another order (measured 3.0e-7 absolute).
        np.testing.assert_allclose(got, from_mat, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, from_mat)


def test_cube_store_over_envi_pairs(tmp_path):
    from sshslie_tpu.data.datasets import CubeStore as JaxStore
    from sshslie_torch.config import load_config
    from sshslie_torch.data.datasets import CubeStore, store_from_config

    rng = np.random.default_rng(5)
    for i in range(3):
        io_envi.save_envi(str(tmp_path / f"c{i}"), (rng.random((12, 10, 4)) * 90).astype(np.float32),
                          interleave=("bsq", "bil", "bip")[i])
    cfg = load_config(None, {"data_pattern": "*.hdr", "normalization": "self", "device": "cpu"},
                      finalize=False)
    store = store_from_config(cfg, str(tmp_path))
    want = JaxStore(str(tmp_path), pattern="*.hdr", normalization="self")
    assert type(store) is CubeStore and store.basenames() == want.basenames()
    assert store.shapes == want.shapes == [(12, 10, 4)] * 3 and store.channels == 4
    for a, b in zip(store.cubes, want.cubes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["GT=a/b.mat", "b.mat", "results/run=2/c.mat", "X=runs/x=2/c.hdr",
                                  "=c.mat", "L="])
def test_split_cube_spec_equals_jax(spec):
    assert io_hsi.split_cube_spec(spec) == jax_hsi.split_cube_spec(spec)


def test_load_cube_specs_equals_jax(tmp_path, cube):
    import scipy.io as sio

    os.makedirs(tmp_path / "run=2")
    sio.savemat(str(tmp_path / "run=2" / "c.mat"), {"data": cube})
    hdr, _ = io_envi.save_envi(str(tmp_path / "c"), cube * 2)
    specs = [f"GT={tmp_path}/run=2/c.mat", str(tmp_path / "run=2" / "c.mat"), hdr, f"GT={hdr}"]
    got, want = io_hsi.load_cube_specs(specs), jax_hsi.load_cube_specs(specs)
    assert list(got) == list(want) == ["GT", "c", "c_", "GT_"]
    for k in want:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k])


def test_reference_helpers_equal_jax():
    rng = np.random.default_rng(8)
    p = rng.random((6, 5, 4))
    lo, hi = rng.random((1, 1, 4)), 1 + rng.random((1, 1, 4))
    for name, args in (("inverse_global_normalization", (p, 238.0, 4095.0)),
                       ("inverse_per_channel_normalization", (p, lo, hi)),
                       ("inverse_per_channel_standardization", (p, lo, hi))):
        np.testing.assert_array_equal(getattr(io_hsi, name)(*args), getattr(jax_hsi, name)(*args))
    for args in ((400.0, 1000.0, 204, 10, 20, 3), (414.63, 985.05, 64, 0, 0, 1),
                 (414.63, 985.05, 64, 2, 0, 5)):
        got, want = io_hsi.select_hsi_wavelengths(*args), jax_hsi.select_hsi_wavelengths(*args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for args in ((10, 3, 2.0, 1e-3), (7, 7, 10.0, 0.5), (5, 1, 3.0, 1.0)):
        np.testing.assert_array_equal(io_hsi.adaptive_lr(*args), jax_hsi.adaptive_lr(*args))
    for args in ((1e-3, 0.1, 0.75, 0), (1e-3, 0.1, 0.75, 37), (0.5, 2.0, 2.0, 3.5)):
        assert io_hsi.polynomial_decay(*args) == jax_hsi.polynomial_decay(*args)
