"""What surrounds the one-launch Adam kernel in Python, on the CPU: the leaf
tables `fused_adam.leaf_tables` builds (every element of every leaf in
exactly one chunk, zero-size leaves left out, TABLE_CAPACITY leaves a
table), the vector flag per leaf, `launches_per_update`,
the ctypes layout against the one `csrc/adam.cu` records in its
static_asserts, the table cache, and a walk of the chunk tables through the
plain arithmetic, which must be bit-equal to `adam_update_plain`: the
kernel's work split, run where there is no card.

The CUDA kernel itself runs only on the card: `chip_smoke.py`'s
`kernel_adam` and `kernel_adam_bf16` phases hold it bit-equal to
`adam_update_plain` on the same kinds of tables."""

import bisect
import ctypes
import re

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch.ops import fused_adam as tfa

LR, EPS = 3e-3, 1e-7


def _leaf(numel, rng, moment_dtype=torch.float32, offset=0):
    """(p, m, v, g) of `numel` values; `offset` > 0 makes every tensor a
    view that starts `offset` elements into its buffer."""
    def tensor(values, dtype):
        buf = torch.zeros(numel + offset, dtype=dtype)
        buf[offset:] = torch.from_numpy(values).to(dtype)
        return buf[offset:]
    p = tensor(rng.standard_normal(numel).astype(np.float32) * 0.1,
               torch.float32)
    m = tensor(rng.standard_normal(numel).astype(np.float32) * 0.01,
               moment_dtype)
    v = tensor(rng.random(numel).astype(np.float32) * 1e-4, moment_dtype)
    g = tensor(rng.standard_normal(numel).astype(np.float32) * 0.01,
               torch.float32)
    return p, m, v, g


def _random_quads(seed, n_leaves, moment_dtype=torch.float32):
    """Leaves of random sizes (most not a multiple of 4, some past a
    chunk, some empty) and one unaligned view."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 3 * tfa.CHUNK, size=n_leaves)
    sizes[rng.random(n_leaves) < 0.1] = 0
    sizes[0] = 4 * tfa.CHUNK + 3
    quads = [_leaf(int(n), rng, moment_dtype) for n in sizes]
    quads[n_leaves // 2] = _leaf(1001, rng, moment_dtype, offset=1)
    return quads


def _walk(tables, quads):
    """The kernel's work split on the host: for each chunk of each table,
    (quad index, start, end), its leaf found by the kernel's search (the
    last leaf whose first chunk is at or before the chunk)."""
    by_ptr = {q[0].data_ptr(): i for i, q in enumerate(quads)
              if q[0].numel() > 0}
    spans = []
    for table in tables:
        leaves = table.leaves[:table.n_leaves]
        firsts = [leaf.first_chunk for leaf in leaves]
        for chunk in range(table.chunks):
            leaf = leaves[bisect.bisect_right(firsts, chunk) - 1]
            start = (chunk - leaf.first_chunk) * tfa.CHUNK
            end = min(start + tfa.CHUNK, leaf.numel)
            assert start < end
            spans.append((by_ptr[leaf.p], start, end))
    return spans


@pytest.mark.parametrize('seed,n_leaves', [(0, 7), (1, 20), (2, 64),
                                           (3, 65), (4, 200)])
def test_every_element_lies_in_exactly_one_chunk(seed, n_leaves):
    quads = _random_quads(seed, n_leaves)
    tables = tfa.leaf_tables(quads)
    live = [q for q in quads if q[0].numel() > 0]
    assert len(tables) == tfa.launches_per_update(len(live))
    assert [t.n_leaves for t in tables] == [
        min(tfa.TABLE_CAPACITY, len(live) - i)
        for i in range(0, len(live), tfa.TABLE_CAPACITY)]
    hits = [np.zeros(q[0].numel(), np.int64) for q in quads]
    for i, start, end in _walk(tables, quads):
        hits[i][start:end] += 1
    assert all((h == 1).all() for h in hits)
    for table in tables:
        leaves = table.leaves[:table.n_leaves]
        assert table.chunks == sum(-(-leaf.numel // tfa.CHUNK)
                                   for leaf in leaves)
        assert all(leaf.numel > 0 for leaf in leaves)
        assert [leaf.first_chunk for leaf in leaves] == list(
            np.cumsum([0] + [-(-leaf.numel // tfa.CHUNK)
                             for leaf in leaves[:-1]]))


def test_tables_keep_the_leaves_pointers_in_order():
    quads = _random_quads(5, 70)
    tables = tfa.leaf_tables(quads)
    got = [(leaf.p, leaf.m, leaf.v, leaf.g, leaf.numel)
           for t in tables for leaf in t.leaves[:t.n_leaves]]
    want = [tuple(x.data_ptr() for x in q) + (q[0].numel(),)
            for q in quads if q[0].numel() > 0]
    assert got == want
    assert tfa.leaf_tables([]) == []
    assert tfa.leaf_tables([_leaf(0, np.random.default_rng(0))]) == []


@pytest.mark.parametrize('moment_dtype', [torch.float32, torch.bfloat16])
def test_the_vector_flag_per_leaf(moment_dtype):
    rng = np.random.default_rng(6)
    p, m, v, g = _leaf(999, rng, moment_dtype)
    aligned = (p, m, v, g)
    # one unaligned pointer of the four takes the leaf to the scalar loop
    cases = [aligned, _leaf(999, rng, moment_dtype, offset=1),
             (_leaf(999, rng, moment_dtype, offset=1)[0], m, v, g),
             (p, m, v, _leaf(999, rng, moment_dtype, offset=2)[3]),
             (p, _leaf(999, rng, moment_dtype, offset=1)[1], v, g)]
    flags = [leaf.vec for leaf in tfa.leaf_tables(cases)[0].leaves[:5]]
    assert flags == [1, 0, 0, 0, 0]
    # a view 4 values into its buffer stays aligned (16 bytes of float32,
    # 8 of bfloat16: four bfloat16 moments are 8 bytes); 2 values in, it
    # does not (8 and 4 bytes)
    four = _leaf(999, rng, moment_dtype, offset=4)
    two = _leaf(999, rng, moment_dtype, offset=2)
    flags = [leaf.vec for leaf in tfa.leaf_tables(
        [four, (p, two[1], v, g), (p, m, two[2], g)])[0].leaves[:3]]
    assert flags == [1, 0, 0]


def test_chunks_follow_the_leaf_sizes_at_the_chunk_edges():
    """A leaf of exactly CHUNK values takes one chunk, one value more takes
    two; the next leaf starts at the next chunk."""
    rng = np.random.default_rng(7)
    sizes = [tfa.CHUNK, tfa.CHUNK + 1, 1, 2 * tfa.CHUNK - 1, 3]
    table = tfa.leaf_tables([_leaf(n, rng) for n in sizes])[0]
    assert [leaf.first_chunk for leaf in table.leaves[:5]] == [0, 1, 3, 4, 6]
    assert table.chunks == 7 and table.n_leaves == 5


@pytest.mark.parametrize('n_leaves,launches', [
    (0, 0), (1, 1), (20, 1), (64, 1), (65, 2), (128, 2), (200, 4)])
def test_launches_per_update(n_leaves, launches):
    assert tfa.launches_per_update(n_leaves) == launches
    quads = [_leaf(5, np.random.default_rng(i)) for i in range(n_leaves)]
    assert len(tfa.leaf_tables(quads)) == launches


def _cu_layout():
    """The constants and layout csrc/adam.cu records in static_asserts."""
    src = tfa._SRC.read_text()
    sizes = {name: int(n) for name, n in re.findall(
        r'static_assert\(sizeof\((\w+)\) == (\d+)', src)}
    offsets = {(name, field): int(n) for name, field, n in re.findall(
        r'static_assert\(offsetof\((\w+), (\w+)\) == (\d+)', src)}
    consts = {name: int(n) for name, n in re.findall(
        r'static_assert\((CHUNK|TABLE_CAPACITY) == (\d+)', src)}
    return sizes, offsets, consts


def test_ctypes_layout_is_the_one_the_kernel_source_records():
    sizes, offsets, consts = _cu_layout()
    assert consts == {'CHUNK': tfa.CHUNK,
                      'TABLE_CAPACITY': tfa.TABLE_CAPACITY}
    structs = {'AdamLeaf': tfa._Leaf, 'AdamTable': tfa._Table}
    assert sizes == {name: ctypes.sizeof(s) for name, s in structs.items()}
    # every field of both structures is recorded, at its ctypes offset
    # (the table's padding word aside)
    want = {(name, field): getattr(s, field).offset
            for name, s in structs.items()
            for field, _ in s._fields_ if field != 'pad'}
    assert offsets == want
    # within the kernel's 4 KB of parameters, with its five other arguments
    assert ctypes.sizeof(tfa._Table) + 2 * 8 + 3 * 4 <= 4096


def test_tables_are_cached_by_the_leaves_addresses_and_sizes():
    tfa._TABLES.clear()
    quads = _random_quads(8, 12)
    first = tfa._cached_tables(quads)
    assert tfa._cached_tables(quads) is first
    other = _random_quads(9, 12)
    assert tfa._cached_tables(other) is not first
    assert len(tfa._TABLES) == 2
    # leaves kept alive, so that no two sets share addresses; the oldest
    # tables go first
    alive = [_random_quads(seed, 2)
             for seed in range(10, 10 + tfa._TABLES_KEPT)]
    for leaves in alive:
        tfa._cached_tables(leaves)
    assert len(tfa._TABLES) == tfa._TABLES_KEPT
    assert tfa._cached_tables(alive[-1]) is tfa._cached_tables(alive[-1])
    assert tfa._cached_tables(quads) is not first
    # the same addresses and sizes with other moment types are another key
    retyped = [(p, m.view(torch.bfloat16)[::2], v.view(torch.bfloat16)[::2],
                g) for p, m, v, g in quads[:1]]
    assert retyped[0][1].data_ptr() == quads[0][1].data_ptr()
    assert tfa._cached_tables(retyped) is not tfa._cached_tables(quads[:1])
    tfa._TABLES.clear()


@pytest.mark.parametrize('moment_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n_leaves', [9, 200])
def test_chunk_walk_through_the_plain_arithmetic_is_the_plain_update(
        moment_dtype, n_leaves):
    """Three steps: each applies `_plain` chunk by chunk, in the tables'
    order, and must leave p, m and v bit-equal to `adam_update_plain` on a
    copy of the same leaves."""
    quads = _random_quads(11, n_leaves, moment_dtype)
    twin = [tuple(t.clone() for t in q) for q in quads]
    params = {'enc': [(q[0],) for q in twin]}
    state = tfa.AdamState(
        count=torch.zeros((), dtype=torch.int32),
        mu={'enc': [(q[1],) for q in twin]},
        nu={'enc': [(q[2],) for q in twin]},
        learning_rate=torch.tensor(LR, dtype=torch.float32), eps=EPS)
    grads = {'enc': [(q[3],) for q in twin]}
    tables = tfa.leaf_tables(quads)
    spans = _walk(tables, quads)
    count = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        count = count + 1
        scalars = tfa._scalars(count, state.learning_rate, 0.9, 0.999)
        for i, start, end in spans:
            tfa._plain([tuple(t.view(-1)[start:end] for t in quads[i])],
                       scalars, 0.9, 0.999, EPS)
        state = tfa.adam_update_plain(params, grads, state)
    assert int(state.count) == 3
    for q, r in zip(quads, twin):
        for a, b in zip(q[:3], r[:3]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
