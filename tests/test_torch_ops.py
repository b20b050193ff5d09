"""The port's quantizer ops and initializers against the JAX package's, on
the same numpy inputs. On the CPU the port's nearest-code search runs the
CUDA kernel's plain version; the JAX Pallas kernel runs in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu.ops import initializers as jinit
from pgmvae_tpu.ops import quantizer as jq
from pgmvae_tpu.ops.pallas_vq import vq_codes_fused as jax_fused
from pgmvae_tpu_torch.ops import initializers as tinit
from pgmvae_tpu_torch.ops import quantizer as tq

SHAPES = [
    (3, 9, 5, 7),       # tiny, ragged everything
    (5, 32, 8, 130),    # K just past one lane tile
    (4, 17, 10, 50),    # nltcs-like
    (2, 64, 16, 1024),  # multiple K tiles
    (2, 8, 6, 4096),    # large K
]


def _zw(shape, seed=0):
    n, b, d, k = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b, d)).astype(np.float32),
            rng.standard_normal((n, d, k)).astype(np.float32))


@pytest.mark.parametrize('shape', SHAPES)
def test_vq_codes_bit_equal_to_jax(shape):
    z, w = _zw(shape)
    got = tq.vq_codes(torch.from_numpy(z), torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jq.vq_codes(jnp.asarray(z), jnp.asarray(w),
                                    impl='xla')))
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused(jnp.asarray(z), jnp.asarray(w),
                                  block_b=16, block_k=256, interpret=True)))


def test_vq_codes_tie_lowest_index():
    z = np.zeros((1, 8, 4), np.float32)
    w = np.ones((1, 4, 12), np.float32)       # all codes identical
    got = tq.vq_codes(torch.from_numpy(z), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.zeros((1, 8), np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused(jnp.asarray(z), jnp.asarray(w),
                                  interpret=True)))


@pytest.mark.parametrize('impl', ['auto', 'xla', 'pallas', 'pallas_interpret'])
def test_vq_codes_every_impl_same_path(impl):
    z, w = _zw((4, 16, 8, 32), seed=1)
    got = tq.vq_codes(torch.from_numpy(z), torch.from_numpy(w), impl=impl)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.vq_codes(jnp.asarray(z), jnp.asarray(w))))


def test_vq_codes_rejects_unknown_impl():
    z, w = _zw((2, 4, 3, 5))
    with pytest.raises(ValueError, match='unknown vq impl'):
        tq.vq_codes(torch.from_numpy(z), torch.from_numpy(w), impl='triton')


@pytest.mark.parametrize('shape', SHAPES[:4])
def test_vq_distances_match_jax(shape):
    z, w = _zw(shape, seed=2)
    got = tq.vq_distances(torch.from_numpy(z), torch.from_numpy(w)).numpy()
    ref = np.asarray(jq.vq_distances(jnp.asarray(z), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_vq_quantize_and_naive_codes_match_jax():
    z, w = _zw((4, 16, 5, 9), seed=3)
    idx = np.random.default_rng(3).integers(0, 9, (4, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        tq.vq_quantize(torch.from_numpy(w), torch.from_numpy(idx)).numpy(),
        np.asarray(jq.vq_quantize(jnp.asarray(w), jnp.asarray(idx))))
    zn = (z * 0.8 + 0.5).astype(np.float32)   # spans the clip at 0 and 1
    zn[0, 0, :3] = [0.5, 1.5, -0.5]           # round-half-even and clips
    got = tq.naive_codes(torch.from_numpy(zn)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jq.naive_codes(
        jnp.asarray(zn))))


@pytest.mark.parametrize('n,b,k', [(16, 128, 50), (1058, 1024, 512),
                                   (1058, 1024, 4096), (1, 1, 1)])
def test_auto_impl_rule_matches_jax(n, b, k):
    assert tq.auto_impl(n, b, k) == jq.auto_impl(n, b, k)
    assert tq.AUTO_PALLAS_BYTES == jq.AUTO_PALLAS_BYTES


FAN_SHAPES = [(7,), (5, 3), (16, 16, 15), (1058, 20, 50), (4, 2, 3, 5)]


@pytest.mark.parametrize('fan_mode', ['tf_stacked', 'per_network'])
def test_fans_and_limits_exact(fan_mode):
    for shape in FAN_SHAPES:
        if fan_mode == 'per_network' and len(shape) < 2:
            continue
        assert tinit._fans(shape, fan_mode) == jinit._fans(shape, fan_mode)
        fan_in, fan_out = jinit._fans(shape, fan_mode)
        for scale, mode, denom in (
                (2.0, 'fan_in', max(1.0, fan_in)),
                (1.0, 'fan_avg', max(1.0, (fan_in + fan_out) / 2.0)),
                (1.0, 'fan_out', max(1.0, fan_out))):
            assert tinit.variance_scaling_limit(
                shape, scale, mode, fan_mode) == float(
                    np.sqrt(3.0 * scale / denom))


@pytest.mark.parametrize('fan_mode', ['tf_stacked', 'per_network'])
def test_initializers_draw_within_limits(fan_mode):
    gen = torch.Generator().manual_seed(0)
    shape = (6, 40, 30)
    for fn, scale, mode in ((tinit.he_uniform, 2.0, 'fan_in'),
                            (tinit.glorot_uniform, 1.0, 'fan_avg')):
        w = fn(gen, shape, fan_mode=fan_mode)
        limit = tinit.variance_scaling_limit(shape, scale, mode, fan_mode)
        assert w.shape == shape and w.dtype == torch.float32
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.95 * limit     # spans the range
        assert abs(float(w.mean())) < 0.05 * limit


def test_initializers_reject_unknown_modes():
    with pytest.raises(ValueError, match='fan_mode'):
        tinit._fans((2, 3), 'keras')
    with pytest.raises(ValueError, match='mode'):
        tinit.variance_scaling_limit((2, 3), mode='fan_max')
