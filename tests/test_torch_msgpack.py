"""The port's msgpack codec (`pgmvae_tpu_torch/utils/msgpack.py`) against the
`msgpack` package: the same bytes as `msgpack.packb(..., use_bin_type=True)`
at every width boundary of every type flax's checkpoints use, the same
values decoded, and flax's own blobs decoded."""

import msgpack
import numpy as np
import pytest
from flax import serialization

from pgmvae_tpu_torch.utils import msgpack as tm

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
        2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _check(value):
    ref = msgpack.packb(value, use_bin_type=True)
    assert tm.packb(value) == ref
    assert tm.unpackb(ref) == msgpack.unpackb(ref, raw=False,
                                              strict_map_key=False)


@pytest.mark.parametrize('value', INTS + [None, True, False, 0.0, -0.0, 1.5,
                                          -2.5e-300, float('inf')])
def test_scalars(value):
    _check(value)


@pytest.mark.parametrize('n', LENGTHS)
def test_str_and_bin(n):
    _check('a' * n)
    _check(b'\x00' * n)
    _check('é' * (n // 2))          # lengths count utf-8 bytes


@pytest.mark.parametrize('n', [0, 1, 15, 16, 65535, 65536])
def test_arrays_and_maps(n):
    _check(list(range(n)))
    _check(tuple(range(n)))
    _check({str(i): i for i in range(n)})


@pytest.mark.parametrize('n', [0, 1, 2, 3, 4, 5, 8, 16, 17, 255, 256, 65535,
                               65536])
def test_ext(n):
    data = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    ref = msgpack.packb(msgpack.ExtType(7, data))
    assert tm.packb(tm.ExtType(7, data)) == ref
    # data given in parts packs the same bytes
    assert tm.packb(tm.ExtType(7, [data[:n // 3], data[n // 3:]])) == ref
    assert tm.unpackb(ref) == tm.ExtType(7, data)
    assert tm.unpackb(ref, ext_hook=lambda code, d: (code, d)) == (7, data)


def test_nested_and_float32():
    value = {'b': [1, (2, 3), {'x': None}], 'a': 'é', 'c': b'xy'}
    _check(value)
    # a map keeps its own key order; float32 decodes
    assert list(tm.unpackb(tm.packb(value))) == ['b', 'a', 'c']
    assert tm.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


@pytest.mark.parametrize('bad,error', [(2 ** 64, OverflowError),
                                       (-2 ** 63 - 1, OverflowError),
                                       (np.float32(1.0), TypeError),
                                       (object(), TypeError)])
def test_refuses_what_it_cannot_pack(bad, error):
    with pytest.raises(error):
        tm.packb(bad)


def test_refuses_bad_input():
    with pytest.raises(ValueError, match='ends early'):
        tm.unpackb(msgpack.packb('abc')[:-1])
    with pytest.raises(ValueError, match='extra data'):
        tm.unpackb(msgpack.packb(1) + b'\x00')
    with pytest.raises(ValueError, match='not supported'):
        tm.unpackb(b'\xc1')


def test_decodes_flax_blobs():
    tree = {'w': np.arange(6, dtype=np.float32).reshape(2, 3),
            'n': {'s': np.asarray(3, np.int32), 'e': {}, 'z': None}}
    blob = serialization.msgpack_serialize(tree)
    out = tm.unpackb(blob)
    assert list(out) == ['n', 'w'] and list(out['n']) == ['e', 's', 'z']
    assert out['n']['e'] == {} and out['n']['z'] is None
    code, data = out['w']
    assert code == 1
    shape, dtype, raw = tm.unpackb(data)
    assert shape == [2, 3] and dtype == 'float32'
    np.testing.assert_array_equal(
        np.frombuffer(raw, np.float32).reshape(shape), tree['w'])
    # and re-packs to flax's bytes
    assert tm.packb(out) == blob
