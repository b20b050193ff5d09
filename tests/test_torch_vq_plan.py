"""The nearest-code kernel's launch plans (`cuda_vq.plan` for float32,
`cuda_vq.plan_bf16` for the bfloat16 tensor-core kernel) and their merge
order, on the CPU. The plans are pure Python; the merge is held by a plain
version of it (`strip_merge_plain`): the scores of `vq_codes_plain`, cut
into a plan's code strips, argmin per strip and merged by (value, lowest
index), must give `vq_codes_plain`'s codes and the JAX Pallas kernel's
(interpret mode) bit for bit, ties across a strip edge included. The
float32 instance's whole selection order (`kernel_order_plain`: a lane's
grouped minimum, the lane and warp merges by (value, group), the
resolution inside the winning group, the strip merge) must give
`torch.argmin`'s first index."""

import re
from pathlib import Path

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


NO_CODE = 2 ** 31 - 1      # csrc/vq_argmin.cu: a lane that holds no code


def _lex_min(val, idx, dim):
    """(value, index) minima along `dim` by the kernel's `better`: the
    lower value, then the lower index."""
    low = val.amin(dim, keepdim=True)
    return (low.squeeze(dim),
            torch.where(val == low, idx, NO_CODE).amin(dim))


def kernel_order_plain(scores: torch.Tensor, p) -> torch.Tensor:
    """The float32 kernel's selection order under plan `p`, in plain
    PyTorch, on scores [n, B, K]: codes past K score +inf (|W_k|^2 = +inf
    there). Each code lane (a warp's wk, a thread's tx) walks its groups of
    RK codes upward (ring tiles, then sub-tiles). With sub-tiles (p.sub >
    1) it keeps a group's minimum, with the group's first code, only on a
    strict <; the lanes' (minimum, group) merge by (value, lowest group)
    over the TX lanes and the WK warps; the winning group's lowest code that
    reaches the minimum, by a strict < walk, is the strip's. Without (p.sub
    = 1) every score is compared on its own, strict <, and the lanes'
    (minimum, code) merge the same way. The strips merge in order by strict
    <. int32 [n, B]; a sample with no code below +inf gets 0."""
    n, b, k = scores.shape
    rk = cuda_vq.RK
    lanes = p.tk // p.sub // rk                   # wk * TX
    groups = p.strip_k // p.tk * p.sub           # a lane's groups a strip
    inf = float('inf')
    pad = torch.full((n, b, p.strips * p.strip_k), inf)
    pad[:, :, :k] = scores
    s = pad.view(n, b, p.strips, groups, lanes, rk)
    first = torch.arange(p.strips * p.strip_k).view(
        p.strips, groups, lanes, rk)[..., 0]     # a group's first code
    if p.sub == 1:          # every score compared and selected, strict <
        best = torch.full(s[:, :, :, 0, :, 0].shape, inf)
        grp = torch.full(best.shape, NO_CODE)
        for g in range(groups):
            for c in range(rk):
                take = s[:, :, :, g, :, c] < best
                best = torch.where(take, s[:, :, :, g, :, c], best)
                grp = torch.where(take, first[:, g] + c, grp)
    else:                   # the grouped minimum
        gmin = s.amin(-1)                         # [n, B, strips, G, L]
        best = torch.full(gmin[:, :, :, 0].shape, inf)
        grp = torch.full(best.shape, NO_CODE)
        for g in range(groups):
            take = gmin[:, :, :, g] < best
            best = torch.where(take, gmin[:, :, :, g], best)
            grp = torch.where(take, first[:, g], grp)
    # lanes: [.., wk, TX]; shuffles over TX, then the warps in shared memory
    best = best.view(n, b, p.strips, p.wk, cuda_vq.TX)
    best, grp = _lex_min(*_lex_min(best, grp.view(best.shape), 4), 3)
    val, idx = best, grp
    if p.sub > 1:           # the winning group's codes, upward, strict <
        pad = pad.view(n, b, p.strips, p.strip_k)
        val = torch.full(best.shape, inf)
        idx = torch.full(best.shape, NO_CODE)
        for c in range(rk):
            code = grp + c
            sc = torch.gather(pad, 3, (code % p.strip_k)[..., None])[..., 0]
            take = (grp != NO_CODE) & (sc < val)
            val = torch.where(take, sc, val)
            idx = torch.where(take, code, idx)
    out_v, out_i = torch.full((n, b), inf), torch.full((n, b), NO_CODE)
    for st in range(p.strips):                    # the merge launch
        take = val[:, :, st] < out_v
        out_v = torch.where(take, val[:, :, st], out_v)
        out_i = torch.where(take, idx[:, :, st], out_i)
    return torch.where(out_i == NO_CODE, 0, out_i).to(torch.int32)


def _first_argmin(scores: torch.Tensor) -> np.ndarray:
    return torch.argmin(scores, dim=2).to(torch.int32).numpy()


def _f32_plan(plan_shape):
    """The float32 plan of a MERGE_CASES plan shape (a bfloat16 case's
    shape, planned for the float32 instance)."""
    return cuda_vq.plan(*(plan_shape[1] if plan_shape[0] == 'bf16'
                          else plan_shape))


@pytest.mark.parametrize('shape,plan_shape', MERGE_CASES)
def test_kernel_order_bit_equal(shape, plan_shape):
    z, w = _zw(shape, seed=7)
    scores = _scores(z, w)
    got = kernel_order_plain(scores, _f32_plan(plan_shape)).numpy()
    np.testing.assert_array_equal(got, _first_argmin(scores))
    np.testing.assert_array_equal(
        got, cuda_vq.vq_codes_plain(torch.from_numpy(z),
                                    torch.from_numpy(w)).numpy())


def _tie_pairs(kind: str, p):
    """(first copies, repeats) of codes for a tie of `kind` under the
    float32 plan p (a plan with four sub-tiles a ring tile): inside one
    thread's group; across the groups of one lane (its next sub-tile, its
    next ring tile); across the edge of a sub-tile, a ring tile, a strip
    (other lanes)."""
    tks, lanes = p.tk // p.sub, range(16)
    if kind == 'in_group':
        return [4 * j for j in lanes], [4 * j + 2 for j in lanes]
    if kind == 'lane_next_group':
        return [4 * j + 3 for j in lanes], [tks + 4 * j for j in lanes]
    if kind == 'lane_next_tile':
        last = (p.sub - 1) * tks
        return ([last + 4 * j + 3 for j in lanes],
                [p.tk + 4 * j for j in lanes])
    edge = {'sub_tile_edge': tks, 'ring_tile_edge': p.tk,
            'strip_edge': p.strip_k}[kind]
    return list(range(edge - 16, edge)), list(range(edge, edge + 16))


@pytest.mark.parametrize('kind', ['in_group', 'lane_next_group',
                                  'lane_next_tile', 'sub_tile_edge',
                                  'ring_tile_edge', 'strip_edge'])
def test_kernel_order_ties_first_copy_wins(kind):
    """Codes repeated inside a thread's group of RK codes, across the
    groups of one lane and across sub-tile, ring-tile and strip edges, at
    the kdd plan: every sample sits next to a first copy, and the first
    copy must win."""
    p = cuda_vq.plan(*KDD_BATCH)
    assert p.sub == cuda_vq.SUB and p.strips > 1 and p.strip_k > p.tk
    first, repeat = _tie_pairs(kind, p)
    assert not set(first) & set(repeat)
    assert all(f < r for f, r in zip(first, repeat))
    z, w = _zw((2, 32, 10, 4096), seed=4)
    w[:, :, repeat] = w[:, :, first]
    src = np.asarray(first)[np.arange(32) % len(first)]
    rng = np.random.default_rng(5)
    z = (np.transpose(w[:, :, src], (0, 2, 1))
         + 1e-3 * rng.standard_normal((2, 32, 10))).astype(np.float32)
    scores = _scores(z, w)
    got = kernel_order_plain(scores, p).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(src, got.shape))
    np.testing.assert_array_equal(got, _first_argmin(scores))


@pytest.mark.parametrize('shape,plan_shape', [
    ((2, 24, 10, 4097), (11, 1000, 10, 4097)),   # sub-tiles: grouped
    ((3, 20, 10, 4097), (3, 20, 10, 4097)), ((2, 9, 5, 7), (2, 9, 5, 7)),
    ((4, 33, 20, 50), (4, 33, 20, 50)), ((2, 40, 8, 130), (2, 40, 8, 130))])
def test_kernel_order_ragged_k(shape, plan_shape):
    """K past a multiple of the ring tile: the last strip's tail scores
    +inf and never wins, and samples next to the last code take it."""
    n, b, d, k = shape
    p = cuda_vq.plan(*plan_shape)
    assert k % p.tk != 0 and plan_shape[3] == k
    z, w = _zw(shape, seed=11)
    z[:, :b // 2] = w[:, None, :, k - 1] + 1e-3
    scores = _scores(z, w)
    got = kernel_order_plain(scores, p).numpy()
    np.testing.assert_array_equal(got, _first_argmin(scores))
    assert (got[:, :b // 2] == k - 1).all()


@pytest.mark.parametrize('shape', [KDD_BATCH, (11, 1000, 10, 4097),
                                   (3, 20, 10, 4097)])
def test_kernel_order_all_equal_gives_zero(shape):
    n, b, _, k = shape
    got = kernel_order_plain(torch.zeros((2, 5, k)), cuda_vq.plan(*shape))
    assert got.dtype == torch.int32 and int(got.abs().max()) == 0


def test_plan_smem_holds_the_norm_table():
    """A block's shared memory: the z tile, the ring, the ring tile's
    |W_k|^2 table and the merge buffer (csrc/vq_argmin.cu `smem_floats`)."""
    for shape in PLAN_SHAPES:
        d = shape[2]
        p = cuda_vq.plan(*shape)
        assert p.smem_bytes == 4 * p.vpb * (
            d * (p.tb + 4) + cuda_vq.STAGES * d * p.tk + p.tk
            + 2 * p.wk * p.tb), shape
    src = (Path(cuda_vq.__file__).parent / 'csrc' / 'vq_argmin.cu').read_text()
    assert ('return vpb * (D * (tb + 4) + STAGES * D * tk + tk + 2 * wk * tb);'
            in src)


def test_exact_d_dispatch():
    """The kernel's instances with no exit in the d loop are the D of
    EXACT_D, tried before the padded ladder; the registry's recipes (kdd
    and nltcs D 10, bbc 20, ad 30) and the benchmark's configurations train
    only those D."""
    import json
    src = (Path(cuda_vq.__file__).parent / 'csrc' / 'vq_argmin.cu').read_text()
    body = src[src.index('cudaError_t dispatch('):]
    body = body[:body.index('#undef VQ_LAUNCH')]
    exact = re.findall(r'if \(s\.D == (\d+)\) return VQ_LAUNCH\(\1, true\)',
                       body)
    assert tuple(int(d) for d in exact) == cuda_vq.EXACT_D
    assert body.index('true)') < body.index('false)')
    root = Path(__file__).resolve().parent.parent
    for cfg in ('kdd', 'bbc'):
        dim = json.loads((root / 'benchmark' / 'configs'
                          / f'{cfg}.json').read_text())['dim']
        assert dim in cuda_vq.EXACT_D, cfg


def test_fused_raises_off_cpu_and_cuda():
    """No fallback: a tensor on neither the CPU nor a CUDA device raises."""
    z = torch.zeros((2, 8, 4), device='meta')
    w = torch.zeros((2, 4, 16), device='meta')
    with pytest.raises(ValueError):
        cuda_vq.vq_codes_fused(z, w)
