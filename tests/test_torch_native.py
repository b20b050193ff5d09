"""The port's native CSV parser (`pgmvae_tpu_torch/data/native.py`, built
from `native/fastcsv.cpp` into the port's build directory) against the
numpy path and the JAX package's binding of the same source: equal arrays
with and without a trailing newline, files of another layout left to the
fallback, and the loader's path order (native, numpy, genfromtxt)."""

import numpy as np
import pytest

from pgmvae_tpu.data import native as jnative
from pgmvae_tpu_torch.data import loader, native
from pgmvae_tpu_torch.ops._build import BUILD_DIR


def _rows(n=300, n_var=16, seed=0):
    return np.random.default_rng(seed).integers(0, 2, (n, n_var),
                                                dtype=np.uint8)


def _write(path, y, newline='\n', trailing=True):
    text = newline.join(','.join(map(str, r)) for r in y)
    path.write_bytes((text + (newline if trailing else '')).encode())
    return str(path)


def _numpy_path(path, n_var, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, 'parse_binary_csv', lambda *a: None)
        return loader.load_binary_csv(path, n_var)


@pytest.mark.parametrize('trailing', [True, False])
@pytest.mark.parametrize('n,n_var', [(300, 16), (5000, 64), (1, 3)])
def test_native_equals_numpy_and_jax(tmp_path, monkeypatch, trailing, n,
                                     n_var):
    y = _rows(n, n_var)
    path = _write(tmp_path / 'y.data', y, trailing=trailing)
    got = native.parse_binary_csv(path, n_var)
    assert native.unavailable() is None
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(got, y)
    np.testing.assert_array_equal(got, _numpy_path(path, n_var, monkeypatch))
    np.testing.assert_array_equal(got, jnative.parse_binary_csv(path, n_var))


def test_crlf_file_goes_to_the_fallback(tmp_path):
    y = _rows(40, 6)
    path = _write(tmp_path / 'y.data', y, newline='\r\n')
    assert native.parse_binary_csv(path, 6) is None
    assert jnative.parse_binary_csv(path, 6) is None
    before = native.PARSES
    np.testing.assert_array_equal(loader.load_binary_csv(path, 6), y)
    assert native.PARSES == before


def test_loader_takes_the_native_path_first(tmp_path):
    y = _rows(64, 16)
    path = _write(tmp_path / 'y.data', y)
    before = native.PARSES
    np.testing.assert_array_equal(loader.load_binary_csv(path, 16), y)
    assert native.PARSES == before + 1


def test_unavailable_parser_falls_back_to_numpy(tmp_path, monkeypatch):
    y = _rows(64, 16)
    path = _write(tmp_path / 'y.data', y)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_why', 'RuntimeError: g++ not found')
    assert native.parse_binary_csv(path, 16) is None
    assert native.unavailable().startswith('RuntimeError')
    np.testing.assert_array_equal(loader.load_binary_csv(path, 16), y)


def test_library_is_built_into_the_port_build_directory():
    so = native.library_path()
    assert so.parent == BUILD_DIR and so.name.startswith('libfastcsv-')
    native.parse_binary_csv(__file__, 3)          # builds at first use
    assert so.exists()
    assert native.SOURCE.name == 'fastcsv.cpp'
    assert native.SOURCE.parent.name == 'native'
