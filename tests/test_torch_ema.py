"""The EMA codebook step's kernel (`ops/cuda_ema.py`, `csrc/ema_update.cu`)
on the CPU: where a train step takes it and where the dense path, the
fused step's one contract (the state's own tensors written in place) on
the CPU and the train step's copy-back it removes, the perplexity a train
step reads from its batch counts, what the wrapper refuses before it
launches anything, and the launch plans at the main paths' shapes
(`cuda_ema.plan`, against the source's constants). The kernel itself is
held to its plain version on the card (chip_smoke.py, phase
kernel_ema)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch import train as ttrain
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_ema, kernels
from pgmvae_tpu_torch.ops import quantizer as q

SRC = Path(cuda_ema.__file__).resolve().parent / 'csrc' / 'ema_update.cu'
CFG = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25,
                     decay=0.9, quantizer='ema')


def _inputs(n=5, b=9, d=4, k=11, seed=0, step=0, zero_debias=True):
    """A state after `step` steps (counts and dw not all zero past step
    0), z, codes and 0/1 weights with two padded rows."""
    rng = np.random.default_rng(seed)
    cb = torch.from_numpy(rng.standard_normal((n, d, k)).astype(np.float32))
    state = q.ema_init(cb, zero_debias)
    if step:
        state = q.EmaState(
            cb, torch.from_numpy(rng.uniform(0, 2, (n, k)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, d, k))
                             .astype(np.float32)),
            torch.tensor(step, dtype=torch.int32))
    z = torch.from_numpy(rng.standard_normal((n, b, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, k, (n, b)).astype(np.int32))
    w = torch.ones(b)
    w[[2, b - 1]] = 0.0
    return state, z, idx, w


@pytest.fixture
def no_launch(monkeypatch):
    """Building the kernel fails the test: nothing may reach a launch."""
    def build():
        raise AssertionError('the kernel was built')
    monkeypatch.setattr(cuda_ema, 'build', build)
    monkeypatch.setattr(kernels, '_COUNTS',
                        dict.fromkeys(kernels.counts(), 0))


# ------------------------------------------------------------ dispatch --

@pytest.mark.parametrize('zero_debias', [True, False])
@pytest.mark.parametrize('step', [0, 40])
@pytest.mark.parametrize('weighted', [True, False])
def test_the_cpu_takes_the_plain_version(no_launch, zero_debias, step,
                                         weighted):
    """On CPU tensors the fused step is `code_stats` + `ema_update`, bit for
    bit, written into the state's own tensors as the kernel writes them:
    the state it returns holds them, with the next step."""
    state, z, idx, w = _inputs(step=step, zero_debias=zero_debias)
    w = w if weighted else None
    before = q.EmaState(*(t.clone() for t in state))
    got, counts = cuda_ema.ema_update_fused(state, z, idx, w, 0.9, 1e-5,
                                            zero_debias)
    want_counts, dw = q.code_stats(z, idx, 11, w)
    want = q.ema_update(before, want_counts, dw, 0.9, 1e-5, zero_debias)
    assert torch.equal(counts, want_counts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(a is b for a, b in zip(got[:3], state[:3]))
    assert torch.equal(state.step, before.step)
    assert kernels.counts()['ema'] == 0


def test_a_cpu_train_step_goes_through_the_fused_step(monkeypatch):
    """`Trainer._step` reaches the EMA step through
    `cuda_ema.ema_update_fused`, which on the CPU runs its plain version
    once a step."""
    calls = []
    plain = cuda_ema.ema_update_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(cuda_ema, 'ema_update_plain', counted)
    tr = ttrain.Trainer(CFG, 0.01, 8, 16, device='cpu')
    st = tr.init_state(3)
    y = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, (8, 6)).astype(np.float32))
    st, _ = tr.train_step(st, y, torch.ones(8))
    st, _ = tr.train_step(st, y, torch.ones(8))
    assert len(calls) == 2


class _StubMesh:
    """A MeshContext stand-in of a given shape whose all-reduce records
    its axis and sums nothing (one rank's view)."""

    def __init__(self, shape):
        self.shape, self.reduced = shape, []

    def all_reduce_many(self, tensors, axis='world'):
        self.reduced.append(axis)
        return list(tensors)


def test_a_data_axis_of_two_ranks_takes_the_dense_path(monkeypatch):
    """More than one 'data' rank: the statistics are summed over 'data'
    before the update, so the step takes `code_stats`, the all-reduce and
    `ema_update`, not the fused step."""
    def refuse(*args, **kw):
        raise AssertionError('the fused step ran under a data axis')
    monkeypatch.setattr(cuda_ema, 'ema_update_fused', refuse)
    state, z, idx, w = _inputs(n=6, k=7, d=3)
    mesh = _StubMesh((2, 1))
    got, counts = ttrain.ema_step(state, z, idx, w, CFG, mesh)
    assert mesh.reduced == ['data']
    want_counts, dw = q.code_stats(z, idx, 7, w)
    want = q.ema_update(state, want_counts, dw, CFG.decay, CFG.epsilon,
                        CFG.zero_debias)
    assert torch.equal(counts, want_counts)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize('shape', [(1, 1), (1, 4)])
def test_one_data_rank_takes_the_fused_step(monkeypatch, shape):
    """No mesh, or a mesh whose 'data' axis has one rank (its networks
    split over 'model'): the fused step, with no all-reduce."""
    calls = []
    monkeypatch.setattr(cuda_ema, 'ema_update_fused',
                        lambda *a, **kw: calls.append(a) or ('ema', 'c'))
    state, z, idx, w = _inputs(n=6, k=7, d=3)
    mesh = _StubMesh(shape)
    assert ttrain.ema_step(state, z, idx, w, CFG, mesh) == ('ema', 'c')
    assert len(calls) == 1 and mesh.reduced == []


# ------------------------------------------------------------ refusals --

def _bad(case):
    state, z, idx, w = _inputs()
    n, b, d, k = 5, 9, 4, 11
    if case == 'z float64':
        z = z.double()
    elif case == 'indices int64':
        idx = idx.long()
    elif case == 'state bfloat16':
        state = state._replace(dw=state.dw.bfloat16())
    elif case == 'weights float64':
        w = w.double()
    elif case == 'z 2-D':
        z = z[0]
    elif case == 'indices [n, B+1]':
        idx = torch.zeros((n, b + 1), dtype=torch.int32)
    elif case == 'counts [n, K+1]':
        state = state._replace(counts=torch.zeros(n, k + 1))
    elif case == 'dw [n, D+1, K]':
        state = state._replace(dw=torch.zeros(n, d + 1, k))
    elif case == 'weights [B+1]':
        w = torch.ones(b + 1)
    elif case == 'dw not contiguous':
        state = state._replace(dw=torch.zeros(n, k, d).transpose(1, 2))
    elif case == 'z not contiguous':
        z = torch.zeros(n, d, b).transpose(1, 2)
    elif case == 'on two devices':
        z = z.to('meta')
    elif case == 'on the meta device':
        state = q.EmaState(*(t.to('meta') for t in state))
        z, idx, w = z.to('meta'), idx.to('meta'), w.to('meta')
    return state, z, idx, w


@pytest.mark.parametrize('case', [
    'z float64', 'indices int64', 'state bfloat16', 'weights float64',
    'z 2-D', 'indices [n, B+1]', 'counts [n, K+1]', 'dw [n, D+1, K]',
    'weights [B+1]', 'dw not contiguous', 'z not contiguous',
    'on two devices', 'on the meta device'])
def test_the_wrapper_refuses_before_any_launch(no_launch, case):
    state, z, idx, w = _bad(case)
    with pytest.raises(ValueError):
        cuda_ema.ema_update_fused(state, z, idx, w, 0.9)
    assert kernels.counts()['ema'] == 0


# --------------------------------------------------------------- plans --

# (n, B, D, K): kdd's train batch alone and packed (S=4), bbc's quality
# recipe and its bs 250 and 1,000, ad's at bs 250, nltcs's headline,
# stream_big's (and cli_big's, sweep_memory's), its packed pair's, and
# bench_cmll's training
MAIN_SHAPES = [(64, 32, 10, 4096), (256, 32, 10, 4096), (1058, 25, 20, 50),
               (1058, 250, 20, 50), (1058, 1000, 20, 50),
               (1556, 250, 30, 20), (16, 128, 10, 50), (64, 256, 10, 64),
               (128, 256, 10, 64), (150, 256, 20, 15)]
# K past one chunk (a block an SM, and two: the nearest-code kernel's
# large-K plan), and batches whose tables leave shared memory
LARGE_SHAPES = [(16, 256, 20, 65536), (1058, 256, 20, 65536),
                (160, 64, 10, 65536), (4, 8192, 20, 8192),
                (1, 20000, 20, 65536)]


@pytest.mark.parametrize('shape', MAIN_SHAPES + LARGE_SHAPES)
def test_plan_covers_the_shape(shape):
    n, b, d, k = shape
    p = cuda_ema.plan(n, b, d, k)
    assert p.grid == n                        # a block a network
    alone = n <= cuda_ema.SMS
    cap = cuda_ema.MAX_THREADS if alone else cuda_ema.SHARED_THREADS
    budget = cuda_ema.SMEM_BYTES if alone else cuda_ema.SHARED_SMEM_BYTES
    assert p.threads & (p.threads - 1) == 0
    assert cuda_ema.MIN_THREADS <= p.threads <= cap
    # one pass of UNROLL float4 groups a thread covers a chunk, or the
    # block is as wide as it may be; a half-size block would not
    per_pass = 4 * cuda_ema.UNROLL * p.threads
    assert per_pass >= d * p.kc or p.threads == cap
    assert (p.threads == cuda_ema.MIN_THREADS
            or per_pass // 2 < d * p.kc)
    assert p.tb == min(b, cuda_ema.TILE_ROWS) and p.slots == min(b, k)
    # the hash: a power of two of at least four entries a slot
    assert 1 << p.hbits >= max(4 * p.slots, 32)
    assert 1 << (p.hbits - 1) < max(4 * p.slots, 32)
    assert p.table_words == 2 * (1 << p.hbits) + p.slots * (d + 2)
    assert p.smem_bytes == 4 * (2 * p.kc + p.tb * (d + 4) + 34 + (
        p.table_words if p.shared_tables else 0))
    assert p.smem_bytes <= budget
    # the chunk: all of K where it fits, else a multiple of 4 that leaves
    # less than 4 codes' room
    assert p.kc == k or (p.kc % 4 == 0 and budget - p.smem_bytes < 32)
    assert p.args == (p.threads, p.tb, p.slots, p.hbits, p.kc)
    # the tables share the block's memory where they leave a chunk of
    # MIN_CHUNK codes (all of K if fewer)
    room = budget - 4 * (2 * min(k, cuda_ema.MIN_CHUNK) + p.tb * (d + 4)
                         + 34)
    assert p.shared_tables == (4 * p.table_words <= room)


def test_plan_of_the_two_cells():
    """The benchmark's training cells: the packed kdd sweep shares SMs (256
    blocks) at 512 threads; bbc's 1,000 values a network take 128; every
    main path's K fits one chunk, with the tables in shared memory."""
    assert cuda_ema.plan(256, 32, 10, 4096)[:6] == (512, 32, 32, 7, 4096,
                                                    True)
    assert cuda_ema.plan(64, 32, 10, 4096)[:6] == (1024, 32, 32, 7, 4096,
                                                   True)
    assert cuda_ema.plan(1058, 25, 20, 50)[:6] == (128, 25, 25, 7, 50, True)
    for shape in MAIN_SHAPES:
        p = cuda_ema.plan(*shape)
        assert p.kc == shape[3] and p.shared_tables, (shape, p)


def test_plan_of_large_k_splits_it_into_chunks():
    """Past what one block's shared memory holds, K goes in chunks: 65,536
    codes take 3 (a block an SM) or 7 (two blocks an SM) passes; a batch
    of 8,192 distinct codes keeps its tables in device memory."""
    p = cuda_ema.plan(16, 256, 20, 65536)
    assert -(-65536 // p.kc) == 3 and p.shared_tables
    p = cuda_ema.plan(1058, 256, 20, 65536)
    assert -(-65536 // p.kc) == 7 and p.shared_tables
    p = cuda_ema.plan(4, 8192, 20, 8192)
    assert p.kc == 8192 and not p.shared_tables


@pytest.mark.parametrize('shape', [(0, 32, 10, 64), (4, 0, 10, 64),
                                   (4, 32, 0, 64), (4, 32, 10, 0),
                                   (4, 32, 4000, 4), (1, 1, 1 << 16,
                                                      1 << 15)])
def test_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        cuda_ema.plan(*shape)


def test_plan_constants_match_the_source():
    """The plan's limits and shared-memory words are the kernel's."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src)[1])
    assert const('MAX_THREADS') == cuda_ema.MAX_THREADS
    assert const('UNROLL') == cuda_ema.UNROLL
    assert const('MAX_SMEM') == cuda_ema.SMEM_BYTES
    assert const('TILE') == cuda_ema.TILE_ROWS
    assert re.search(r'return 2LL \* \(1LL << hbits\) \+ '
                     r'\(long long\)slots \* \(D \+ 2\);', src)
    assert re.search(r'return 2LL \* kc \+ \(long long\)tb \* \(D \+ 4\) '
                     r'\+ 34\s+\+ \(tables \? table_words\(D, slots, hbits\) '
                     r': 0\);', src)


# ------------------------------------------- a train step's copy-back --

def _perplexity(counts):
    """`Trainer._step`'s perplexity of an unpacked step's counts."""
    p = counts / torch.clamp(torch.sum(counts, dim=-1, keepdim=True),
                             min=1.0)
    return torch.mean(torch.exp(-torch.sum(
        p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)))


@pytest.mark.parametrize('case', ['full', 'ragged', 'late step',
                                  'no debias', 'restarts'])
def test_a_train_steps_perplexity_reads_its_batch_counts(monkeypatch, case):
    """The perplexity a train step reports is the one of `code_stats`'
    counts of its codes (today's), read from the batch counts the fused
    step returns."""
    seen = []
    fused = cuda_ema.ema_update_fused

    def kept(state, z, idx, w, *args):
        seen.append((z.clone(), idx.clone(), w.clone()))
        return fused(state, z, idx, w, *args)
    monkeypatch.setattr(cuda_ema, 'ema_update_fused', kept)
    cfg = CFG._replace(zero_debias=case != 'no debias',
                       dead_code_threshold=0.25 if case == 'restarts'
                       else 0.0)
    tr = ttrain.Trainer(cfg, 0.01, 8, 16, device='cpu')
    st = tr.init_state(3)
    rng = np.random.default_rng(2)
    w = torch.ones(8)
    if case == 'ragged':
        w[5:] = 0.0
    gen = torch.Generator().manual_seed(4) if case == 'restarts' else None
    for _ in range(3 if case == 'late step' else 1):
        y = torch.from_numpy(rng.integers(0, 2, (8, 6)).astype(np.float32))
        st, m = tr.train_step(st, y, w, gen)
    z, idx, w = seen[-1]
    counts, _ = q.code_stats(z, idx, cfg.num_codes, w)
    assert torch.equal(m[3], _perplexity(counts))


def test_a_train_step_copies_nothing_back_into_the_ema_state(monkeypatch):
    """The fused step writes into the state's tensors, so the epoch body's
    copy-back (`_advance`, through `_assign`) copies none of the EMA
    tensors, and they keep their storage across a fit."""
    calls, copied = [], []
    real = ttrain._assign

    def assign(dst, src):
        calls.append(1)
        if dst is not src and dst.data_ptr() != src.data_ptr():
            copied.append(tuple(dst.shape))
        return real(dst, src)
    monkeypatch.setattr(ttrain, '_assign', assign)
    tr = ttrain.Trainer(CFG, 0.01, 8, 20, device='cpu')
    st = tr.init_state(3)
    ptrs = [t.data_ptr() for t in st.ema[:3]]
    y = np.random.default_rng(5).integers(0, 2, (20, 6)).astype(np.float32)
    st, _ = tr.fit(st, y, 1, seed=1)
    assert calls and [t.data_ptr() for t in st.ema[:3]] == ptrs
    n, d, k = CFG.n_var, CFG.dim, CFG.num_codes
    assert not {(n, d, k), (n, k)} & set(copied), copied


def test_assign_copies_nothing_into_the_tensor_itself(monkeypatch):
    """`_assign` skips a source that is the destination or a view of it
    with its shape (the kernel's packed state), and copies any other."""
    copies = []
    real = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, 'copy_',
                        lambda self, src: copies.append(1) or real(self, src))
    dst = torch.zeros(4, 3, 5)
    ttrain._assign(dst, dst)
    ttrain._assign(dst, dst.flatten(0, 1).view(4, 3, 5))
    assert copies == []
    ttrain._assign(dst, torch.ones(4, 3, 5))
    assert copies == [1] and bool((dst == 1).all())
