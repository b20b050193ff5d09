"""The nearest-code kernel's launch plan (`cuda_vq.plan`) and its merge
order, on the CPU. The plan is pure Python; the merge is held by a plain
version of it (`strip_merge_plain`): the scores of `vq_codes_plain`, cut
into the plan's code strips, argmin per strip and merged by (value, lowest
index), must give `vq_codes_plain`'s codes and the JAX Pallas kernel's
(interpret mode) bit for bit, ties across a strip edge included."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu.ops.pallas_vq import vq_codes_fused as jax_fused
from pgmvae_tpu_torch.ops import cuda_vq

# (n, B, D, K): tests/test_pallas_vq.py's shapes, bbc's stage-2 chunk, test
# split, train batch and large K, the kdd sweep's train batch and stage-2
# chunk, nltcs's widest stage-2 chunk, the widest latent; then a Gibbs
# step's: 11 blocks over bbc's test split, over 1,024 kdd test rows and over
# all 34,955, 16 blocks over nltcs's test split (chip_smoke.GIBBS_SHAPES)
GIBBS_SHAPES = [(11, 330, 20, 50), (11, 1024, 10, 4096),
                (11, 34955, 10, 4096), (16, 3236, 10, 50)]
PLAN_SHAPES = [(3, 9, 5, 7), (5, 32, 8, 130), (4, 17, 10, 50),
               (2, 64, 16, 1024), (1058, 32, 20, 50), (1058, 330, 20, 50),
               (1058, 250, 20, 50), (1058, 256, 20, 4096),
               (64, 32, 10, 4096), (64, 118, 10, 4096), (16, 4096, 10, 50),
               (3, 5, 128, 1000), (1, 1, 1, 1),
               (1058, 256, 20, 65536)] + GIBBS_SHAPES
KDD_BATCH = (64, 32, 10, 4096)
BBC_CHUNK = (1058, 32, 20, 50)


def _zw(shape, seed=0):
    n, b, d, k = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, b, d)).astype(np.float32),
            rng.standard_normal((n, d, k)).astype(np.float32))


def strip_merge_plain(scores: torch.Tensor, strip_k: int) -> torch.Tensor:
    """The kernel's merge order in plain PyTorch: argmin of scores
    [n, B, K] within each strip of `strip_k` codes, then the strips'
    (value, index) minima merged in strip order, lowest index on ties."""
    best = idx = None
    for k0 in range(0, scores.shape[2], strip_k):
        part = scores[:, :, k0:k0 + strip_k]
        arg = torch.argmin(part, dim=2, keepdim=True)   # first on ties
        val = torch.gather(part, 2, arg)[:, :, 0]
        arg = arg[:, :, 0] + k0
        if best is None:
            best, idx = val, arg
        else:               # strict <: an equal value keeps the lower index
            take = val < best
            best, idx = torch.where(take, val, best), torch.where(take, arg,
                                                                  idx)
    return idx.to(torch.int32)


def _scores(z, w):
    """`vq_codes_plain`'s [n, B, K] scores."""
    z, w = torch.from_numpy(z), torch.from_numpy(w)
    return torch.sum(w * w, dim=1, keepdim=True) - 2.0 * torch.bmm(z, w)


@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_plan_covers_the_shape(shape):
    n, b, d, k = shape
    p = cuda_vq.plan(n, b, d, k)
    assert p.grid[0] * p.tb >= b > (p.grid[0] - 1) * p.tb
    assert p.grid[1] * p.vpb >= n > (p.grid[1] - 1) * p.vpb
    assert p.grid[2] == p.strips
    assert p.strips * p.strip_k >= k > (p.strips - 1) * p.strip_k
    # whole code tiles, and no more of them than K needs
    assert p.strip_k % p.tk == 0 and p.strip_k <= -(-k // p.tk) * p.tk
    assert p.rb in (4, 8) and (p.rb == 4 or d <= 32)
    assert p.sub == 1 or (p.sub == cuda_vq.SUB and d <= 32
                          and p.strip_k >= 2 * p.tk)
    assert p.threads == 32 * p.wy * p.wk * p.vpb <= cuda_vq.MAX_THREADS
    assert p.smem_bytes <= cuda_vq.SMEM_BYTES
    assert p.grid[1] <= cuda_vq.MAX_GRID_Y and p.grid[2] <= cuda_vq.MAX_GRID_Y
    if p.strips > 1:         # a split only where the grid was small
        assert p.grid[0] * p.grid[1] < cuda_vq.MIN_BLOCKS


@pytest.mark.parametrize('shape', [(2, 8, 129, 16), (2, 8, 1000, 16),
                                   (0, 8, 4, 16), (2, 0, 4, 16),
                                   (2, 8, 0, 16), (2, 8, 4, 0)])
def test_plan_rejects(shape):
    with pytest.raises(ValueError):
        cuda_vq.plan(*shape)


def test_plan_splits_kdd_and_packs_bbc():
    kdd = cuda_vq.plan(*KDD_BATCH)
    assert kdd.strips > 1 and kdd.vpb == 1
    assert kdd.grid[0] * kdd.grid[1] * kdd.grid[2] >= cuda_vq.MIN_BLOCKS
    bbc = cuda_vq.plan(*BBC_CHUNK)
    assert bbc.vpb > 1 and bbc.strips == 1 and bbc.threads >= 128
    assert bbc.grid[1] * bbc.vpb >= BBC_CHUNK[0]


def test_plan_splits_the_small_gibbs_grids():
    """Eleven variables fill few blocks: the 1,024-row kdd step and bbc's
    test split split K into strips (n = 11 is below the grid the card
    needs); the whole kdd test split fills the card without."""
    for shape in ((11, 1024, 10, 4096), (11, 330, 20, 50)):
        p = cuda_vq.plan(*shape)
        assert p.strips > 1 and p.vpb == 1, (shape, p)
    full = cuda_vq.plan(11, 34955, 10, 4096)
    assert full.strips == 1 and full.grid[0] * full.grid[1] >= \
        cuda_vq.MIN_BLOCKS


# (data shape, the shape whose plan cuts the strips)
MERGE_CASES = [((3, 9, 5, 7), (3, 9, 5, 7)),
               ((5, 32, 8, 130), (5, 32, 8, 130)),
               ((2, 64, 16, 1024), (2, 64, 16, 1024)),
               ((2, 16, 10, 4096), KDD_BATCH),
               ((2, 24, 10, 4096), (64, 118, 10, 4096)),
               ((2, 40, 10, 4096), (11, 1024, 10, 4096)),
               ((3, 33, 20, 50), (11, 330, 20, 50))]


@pytest.mark.parametrize('shape,plan_shape', MERGE_CASES)
def test_strip_merge_bit_equal(shape, plan_shape):
    z, w = _zw(shape, seed=3)
    strip_k = cuda_vq.plan(*plan_shape).strip_k
    got = strip_merge_plain(_scores(z, w), strip_k).numpy()
    plain = cuda_vq.vq_codes_plain(torch.from_numpy(z),
                                   torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused(jnp.asarray(z), jnp.asarray(w),
                                  block_b=16, block_k=512, interpret=True)))


@pytest.mark.parametrize('edge', ['tile', 'strip'])
def test_strip_merge_ties_first_copy_wins(edge):
    """Codes repeated across the kdd plan's tile edge (inside a strip) or
    strip edge (between blocks): every sample sits next to a first copy, and
    the first copy must win."""
    p = cuda_vq.plan(*KDD_BATCH)
    e = p.tk if edge == 'tile' else p.strip_k
    z, w = _zw((2, 32, 10, 4096), seed=4)
    w[:, :, e:e + 16] = w[:, :, e - 16:e]
    src = np.arange(e - 16, e)[np.arange(32) % 16]
    rng = np.random.default_rng(5)
    z = (np.transpose(w[:, :, src], (0, 2, 1))
         + 1e-3 * rng.standard_normal((2, 32, 10))).astype(np.float32)
    got = strip_merge_plain(_scores(z, w), p.strip_k).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(src, got.shape))
    np.testing.assert_array_equal(
        got, cuda_vq.vq_codes_plain(torch.from_numpy(z),
                                    torch.from_numpy(w)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused(jnp.asarray(z), jnp.asarray(w),
                                  block_b=16, block_k=512, interpret=True)))


def test_strip_merge_all_equal_gives_zero():
    scores = torch.zeros((2, 5, 4096))
    got = strip_merge_plain(scores, cuda_vq.plan(*KDD_BATCH).strip_k)
    assert got.dtype == torch.int32 and int(got.max()) == 0


def test_fused_raises_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a CUDA device raises."""
    z = torch.zeros((2, 8, 4), device='meta')
    w = torch.zeros((2, 4, 16), device='meta')
    with pytest.raises(ValueError):
        cuda_vq.vq_codes_fused(z, w)
