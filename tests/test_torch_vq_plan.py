"""The nearest-code kernel's launch plans (`cuda_vq.plan` for float32,
`cuda_vq.plan_bf16` for the bfloat16 tensor-core kernel) and their merge
order, on the CPU. The plans are pure Python; the merge is held by a plain
version of it (`strip_merge_plain`): the scores of `vq_codes_plain`, cut
into a plan's code strips, argmin per strip and merged by (value, lowest
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
# the bfloat16 instance's table shapes (chip_smoke.py's kernel_bf16 rows:
# bbc's train batch at bs 250, 500 and 1,000, large K, kdd's train batch
# alone and packed, nltcs's) and its ragged cases (D = 5, 8, 30, 33, 128;
# K = 7 and 15; B not a multiple of 16)
BF16_SHAPES = [(1058, 250, 20, 50), (1058, 500, 20, 50),
               (1058, 1000, 20, 50), (1058, 256, 20, 4096),
               (64, 32, 10, 4096), (256, 32, 10, 4096), (16, 128, 10, 50),
               (5, 37, 5, 64), (4, 50, 8, 200), (6, 45, 30, 100),
               (3, 29, 33, 96), (2, 21, 128, 300), (13, 100, 20, 15),
               (7, 70, 10, 7), (9, 33, 12, 58)]


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


@pytest.mark.parametrize('shape', BF16_SHAPES + PLAN_SHAPES)
def test_plan_bf16_covers_the_shape(shape):
    """The tensor-core plan: 16-row and 8-code tiles, D padded to a
    multiple of 16, strips that partition K into whole ring tiles, shared
    memory within the block's limit."""
    n, b, d, k = shape
    p = cuda_vq.plan_bf16(n, b, d, k)
    assert p.tb % 16 == 0 and p.tk % 16 == 0 and p.nt % 2 == 0
    assert p.dp % 16 == 0 and p.dp >= d > p.dp // 2 - (p.dp == 16) * 8
    assert p.grid[0] * p.tb >= b > (p.grid[0] - 1) * p.tb
    assert p.grid[1] == n and p.grid[2] == p.strips
    assert p.strips * p.strip_k >= k > (p.strips - 1) * p.strip_k
    assert p.strip_k % p.tk == 0 and p.strip_k <= -(-k // p.tk) * p.tk
    assert p.mt in (1, 2) and (p.mt == 1 or p.ks <= 4)
    assert p.threads == 32 * p.wm <= cuda_vq.MAX_THREADS
    assert p.smem_bytes <= cuda_vq.SMEM_BYTES
    assert p.smem_bytes == (-(-2 * p.tb * d // 16) * 16
                            + 2 * 2 * p.dp * (p.tk + 8) + 4 * p.tk)
    assert p.grid[1] <= cuda_vq.MAX_GRID_Y and p.grid[2] <= cuda_vq.MAX_GRID_Y
    if p.strips > 1:         # a split only where the grid was small, and
        # into strips of two ring tiles or more
        assert p.grid[0] * p.grid[1] * p.wm < cuda_vq.BF16_MIN_WARPS
        assert p.strip_k >= 2 * p.tk
    assert p.args == (p.mt, p.wm, 1, p.nt, 1, p.strip_k, p.strips)


@pytest.mark.parametrize('shape', [(2, 8, 129, 16), (2, 8, 1000, 16),
                                   (0, 8, 4, 16), (2, 0, 4, 16),
                                   (2, 8, 0, 16), (2, 8, 4, 0),
                                   (70000, 8, 4, 16)])
def test_plan_bf16_rejects(shape):
    with pytest.raises(ValueError):
        cuda_vq.plan_bf16(*shape)


@pytest.mark.parametrize('shape,strips', [((64, 32, 10, 4096), 16),
                                          ((256, 32, 10, 4096), 8),
                                          ((1058, 256, 20, 4096), 1),
                                          ((1058, 250, 20, 50), 1)])
def test_plan_bf16_splits_only_small_grids(shape, strips):
    """kdd's train batch (64 one-warp blocks of rows) and its packed batch
    (256) are cut into strips up to BF16_MIN_WARPS warps; bbc's grids are
    not."""
    p = cuda_vq.plan_bf16(*shape)
    assert p.strips == strips
    assert p.grid[0] * p.grid[1] * p.grid[2] * p.wm >= cuda_vq.MIN_BLOCKS


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
               ((3, 33, 20, 50), (11, 330, 20, 50)),
               # the bfloat16 plans' strips, on bfloat16 values
               ((2, 16, 10, 4096), ('bf16', KDD_BATCH)),
               ((2, 24, 10, 4096), ('bf16', (256, 32, 10, 4096))),
               ((2, 40, 8, 130), ('bf16', (2, 40, 8, 130))),
               ((3, 21, 128, 300), ('bf16', (2, 21, 128, 300)))]


def _bf16_values(*arrays):
    """The arrays rounded to bfloat16 and widened back (exact)."""
    return tuple(torch.from_numpy(a).bfloat16().float().numpy()
                 for a in arrays)


def _strip_k(plan_shape) -> int:
    """The strip width of the float32 plan, or of the bfloat16 one for
    ('bf16', shape)."""
    if plan_shape[0] == 'bf16':
        return cuda_vq.plan_bf16(*plan_shape[1]).strip_k
    return cuda_vq.plan(*plan_shape).strip_k


@pytest.mark.parametrize('shape,plan_shape', MERGE_CASES)
def test_strip_merge_bit_equal(shape, plan_shape):
    z, w = _zw(shape, seed=3)
    if plan_shape[0] == 'bf16':
        z, w = _bf16_values(z, w)
        np.testing.assert_array_equal(
            cuda_vq.vq_codes_plain(torch.from_numpy(z).bfloat16(),
                                   torch.from_numpy(w).bfloat16()).numpy(),
            cuda_vq.vq_codes_plain(torch.from_numpy(z),
                                   torch.from_numpy(w)).numpy())
    strip_k = _strip_k(plan_shape)
    got = strip_merge_plain(_scores(z, w), strip_k).numpy()
    plain = cuda_vq.vq_codes_plain(torch.from_numpy(z),
                                   torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got, np.asarray(jax_fused(jnp.asarray(z), jnp.asarray(w),
                                  block_b=16, block_k=512, interpret=True)))


@pytest.mark.parametrize('edge', ['tile', 'strip', 'bf16_tile',
                                  'bf16_strip'])
def test_strip_merge_ties_first_copy_wins(edge):
    """Codes repeated across the kdd plan's tile edge (inside a strip) or
    strip edge (between blocks), by the float32 plan or the bfloat16 one
    (on bfloat16 values): every sample sits next to a first copy, and the
    first copy must win."""
    bf16 = edge.startswith('bf16_')
    p = (cuda_vq.plan_bf16 if bf16 else cuda_vq.plan)(*KDD_BATCH)
    e = p.tk if edge.endswith('tile') else p.strip_k
    assert 16 <= e < p.strips * p.strip_k
    z, w = _zw((2, 32, 10, 4096), seed=4)
    if bf16:
        w, = _bf16_values(w)
    w[:, :, e:e + 16] = w[:, :, e - 16:e]
    src = np.arange(e - 16, e)[np.arange(32) % 16]
    rng = np.random.default_rng(5)
    z = (np.transpose(w[:, :, src], (0, 2, 1))
         + 1e-3 * rng.standard_normal((2, 32, 10))).astype(np.float32)
    if bf16:
        z, = _bf16_values(z)
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
