"""The step bodies over static buffers that the port replays as CUDA graphs
(`pgmvae_tpu_torch/graphs.py`), run here as their plain version, a Python
loop on the CPU: each is bit-equal to the eager loop it replaces (a hand
loop of `train_step` over `_padded_perm`'s rows, of `train_step_packed`,
of the streamed chunks, and of the Gibbs step with a Python index).
`run_epochs`/`run_epochs_packed` are bit-equal to `fit`/`fit_packed`. The
replay launch accounting and the trainer's graph cache are checked as pure
Python with a stub capture."""

import contextlib
import types

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch import gibbs as tg
from pgmvae_tpu_torch import graphs
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import kernels
from pgmvae_tpu_torch.train import EpochMetrics, Trainer, _map_state, \
    copy_state

CFG = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25,
                     decay=0.9, quantizer='ema', dead_code_threshold=0.5)
N, BS = 37, 8            # 5 steps an epoch, the last one ragged
ROW = BS * 6 * 4         # bytes of one batch


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, 6)).astype(np.float32)


def _leaves(state):
    out = []
    _map_state(out.append, state)
    return out


def _assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _eager_epoch(tr, state, data, generator):
    """The epoch as an eager loop: `train_step` on each row of the padded
    permutation, restarts drawn from the epoch's generator, the metrics
    weighted by each step's weights."""
    perm = tr._padded_perm(generator)
    restart = generator if tr.cfg.dead_code_threshold > 0 else None
    total = wtot = 0
    for idx in perm:
        w = (idx >= 0).to(data.dtype)
        state, m = tr.train_step(
            state, data.index_select(0, torch.clamp(idx, min=0)), w, restart)
        total = total + m * torch.sum(w)
        wtot = wtot + torch.sum(w)
    return state, total / wtot


def _eager_epoch_packed(tr, states, data, generators):
    perms = torch.stack([tr._padded_perm(g) for g in generators], 1)
    restart = generators if tr.cfg.dead_code_threshold > 0 else None
    total = wtot = 0
    for idx in perms:
        w = (idx[0] >= 0).to(data.dtype)
        yb = data.index_select(0, torch.clamp(idx.reshape(-1), min=0))
        states, m = tr.train_step_packed(
            states, yb.view(len(generators), BS, -1), w, restart)
        total = total + m * torch.sum(w)
        wtot = wtot + torch.sum(w)
    return states, total / wtot


# ------------------------------------------------------ train bodies --

@pytest.mark.parametrize('over', [{}, {'quantizer': 'vq'},
                                  {'compute_dtype': 'bf16'}])
def test_epoch_body_is_bit_equal_to_the_eager_loop(over):
    """Two epochs of the counter-indexed body (restarts on: they fire and
    draw from the epoch generator) against the hand loop."""
    cfg = CFG._replace(**over)
    y = torch.from_numpy(_data())
    tr = Trainer(cfg, 0.01, BS, N, device='cpu')
    a, b = tr.init_state(3), tr.init_state(3)
    for epoch in range(2):
        a, ma = tr.run_epoch(a, y, tr.epoch_generator(7, epoch))
        b, mb = _eager_epoch(tr, b, y, tr.epoch_generator(7, epoch))
        assert torch.equal(ma, mb)
    _assert_bit_equal(a, b)
    assert int(a.step) == 10 == int(a.opt_state.count)


def test_packed_body_is_bit_equal_to_the_eager_loop():
    y = torch.from_numpy(_data(1))
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    seeds = [4, 9]
    a, b = tr.init_states_packed(seeds), tr.init_states_packed(seeds)
    for epoch in range(2):
        gens = [tr.epoch_generator(s, epoch) for s in seeds]
        a, ma = tr.run_epoch_packed(a, y, gens)
        gens = [tr.epoch_generator(s, epoch) for s in seeds]
        b, mb = _eager_epoch_packed(tr, b, y, gens)
        assert ma.shape == (2, 4) and torch.equal(ma, mb)
    _assert_bit_equal(a, b)


@pytest.mark.parametrize('chunk_steps', [2, 3])
def test_streamed_body_is_bit_equal_to_the_eager_loop(chunk_steps):
    """Chunks of 2, 2, 1 (or 3, 2) steps: the ragged last chunk reuses the
    static chunk buffer's first rows."""
    y = _data(2)
    tr = Trainer(CFG, 0.01, BS, N, stream_bytes=0,
                 stream_chunk_bytes=chunk_steps * ROW, device='cpu')
    assert tr._chunk_steps(y) == chunk_steps
    a, b = tr.init_state(5), tr.init_state(5)
    for epoch in range(2):
        a, ma = tr._run_epoch_streamed(a, y, tr.epoch_generator(1, epoch))
        b, mb = _eager_epoch(tr, b, torch.from_numpy(y),
                             tr.epoch_generator(1, epoch))
        assert torch.equal(ma, mb)
    _assert_bit_equal(a, b)


def test_run_epochs_is_bit_equal_to_fit():
    y = _data(3)
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    a, ms = tr.run_epochs(tr.init_state(2), torch.from_numpy(y), 6, 1, 3)
    b, hist = tr.fit(tr.init_state(2), y, 3, seed=6, start_epoch=1)
    _assert_bit_equal(a, b)
    assert ms.shape == (3, 4)
    assert [EpochMetrics(*row) for row in ms.tolist()] == hist


def test_run_epochs_packed_is_bit_equal_to_fit_packed():
    y = _data(4)
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    seeds = [1, 2]
    a, ms = tr.run_epochs_packed(tr.init_states_packed(seeds),
                                 torch.from_numpy(y), seeds, 2, 2)
    b, hist = tr.fit_packed(tr.init_states_packed(seeds), y, 2, seeds,
                            start_epoch=2)
    _assert_bit_equal(a, b)
    assert ms.shape == (2, 2, 4)
    for k, field in enumerate(EpochMetrics._fields):
        np.testing.assert_array_equal(ms[..., k].numpy(),
                                      getattr(hist, field))


# ------------------------------------------------------------ Gibbs --

def _eager_chain(chain, start, steps, uniform):
    """The Gibbs step with a Python index on the chain's tensors: counts
    added only past burn_in * p1."""
    with torch.no_grad():
        for i in range(start, start + steps):
            y = chain.marker + torch.remainder(i, chain.vol)
            prb = tg.get_probability(chain.params, chain.codebook, chain.cfg,
                                     chain.dist, chain.state, y,
                                     parents=chain.parents)
            gibbs = (uniform(i) < prb).to(chain.state.dtype)
            chain.state.scatter_(
                2, y.view(-1, 1, 1).expand(-1, chain.state.shape[1], 1),
                gibbs[:, :, None])
            if i > chain.burn_in * chain.p1:
                chain.counts.index_add_(1, y, gibbs.T)


@pytest.mark.parametrize('start,steps', [(0, 23), (3, 10)])
def test_gibbs_body_equals_the_eager_step_loop(start, steps, monkeypatch):
    """Sub-segments of G = 5 steps: 23 steps are not a multiple of G, and
    the sub-segment of steps 5-9 (or 8-12) crosses burn_in * p1 = 8."""
    cfg = tv.VqVaeConfig(n_var=9, units=(8, 6), dim=4, num_codes=5)
    params, codebook = tv.init_model(torch.Generator().manual_seed(1), cfg,
                                     device='cpu')
    rng = np.random.default_rng(1)
    dist = rng.uniform(0.1, 0.9, size=(9, 5))
    x = rng.integers(0, 2, size=(16, 9)).astype(np.float32)
    us = torch.from_numpy(rng.random((start + steps, 3, 16)).astype(
        np.float32))
    monkeypatch.setattr(tg, 'UNIFORM_BYTES', 5 * 4 * 3 * 16)
    chain = tg.GibbsChain(params, codebook, cfg, dist, x, 4, 2)
    ref = tg.GibbsChain(params, codebook, cfg, dist, x, 4, 2)
    assert chain.sub_steps == 5 and chain.blocks == 3
    chain.run(start, steps, us.__getitem__)
    _eager_chain(ref, start, steps, us.__getitem__)
    assert torch.equal(chain.state, ref.state)
    assert torch.equal(chain.counts, ref.counts) and ref.counts.sum() > 0
    assert int(chain.i) == start + steps


def test_gibbs_chain_through_the_replay_path(monkeypatch):
    """The chain's graph flow with a stub capture (a replay runs the body):
    the first step is the warm-up, each later one a replay, across
    sub-segments of 8 steps; state and counts equal the eager chain's, and
    `release` drops the graph."""
    cfg = tv.VqVaeConfig(n_var=9, units=(8, 6), dim=4, num_codes=5)
    params, codebook = tv.init_model(torch.Generator().manual_seed(4), cfg,
                                     device='cpu')
    rng = np.random.default_rng(4)
    dist = rng.uniform(0.1, 0.9, size=(9, 5))
    x = rng.integers(0, 2, size=(8, 9)).astype(np.float32)
    us = torch.from_numpy(rng.random((30, 3, 8)).astype(np.float32))
    monkeypatch.setattr(tg, 'UNIFORM_BYTES', 8 * 4 * 3 * 8)
    chain = tg.GibbsChain(params, codebook, cfg, dist, x, 4, 1)
    ref = tg.GibbsChain(params, codebook, cfg, dist, x, 4, 1, graphs=False)
    assert not chain.graph.capture      # on the CPU the body loops
    chain.graph.capture = True
    replays = _stub_graph(monkeypatch, chain.graph, False)
    monkeypatch.setattr(chain.graph, '_replay',
                        lambda: (replays.append(1), chain._step()))
    chain.run(0, 30, us.__getitem__)
    ref.run(0, 30, us.__getitem__)
    assert len(replays) == 29 and chain.sub_steps == 8
    assert torch.equal(chain.state, ref.state)
    assert torch.equal(chain.counts, ref.counts)
    chain.release()
    assert chain.graph.graph is None


def test_cmll_draws_one_block_of_uniforms_a_sub_segment(monkeypatch):
    """The public CMLL fills the buffer with one draw of [g, blocks, B] a
    sub-segment: the same value as a chain fed those draws step by step."""
    cfg = tv.VqVaeConfig(n_var=9, units=(8, 6), dim=4, num_codes=5)
    params, codebook = tv.init_model(torch.Generator().manual_seed(2), cfg,
                                     device='cpu')
    rng = np.random.default_rng(2)
    dist = rng.uniform(0.1, 0.9, size=(9, 5))
    x = rng.integers(0, 2, size=(16, 9)).astype(np.float32)
    monkeypatch.setattr(tg, 'UNIFORM_BYTES', 7 * 4 * 3 * 16)
    got = tg.conditional_marginal_log_likelihood(
        params, codebook, cfg, dist, x, p1=4, num_smp=10, burn_in=3,
        generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    draws = torch.cat([torch.rand((g, 3, 16), generator=gen)
                       for g in (7, 7, 7, 7, 7, 5)])
    chain = tg.GibbsChain(params, codebook, cfg, dist, x, 4, 3)
    assert chain.sample(10, draws.__getitem__) == got


# ---------------------------------------------- launches and the cache --

@pytest.fixture
def counters(monkeypatch):
    """The launch registry for the test alone: every counter at 0, and
    whatever the test registers gone after it."""
    monkeypatch.setattr(kernels, '_COUNTS',
                        dict.fromkeys(kernels.counts(), 0))
    monkeypatch.setattr(kernels, '_BUILDS', kernels.builds())


def _launches(**counts) -> dict:
    """Every registered counter by name: `counts`, the rest 0."""
    return {**dict.fromkeys(kernels.counts(), 0), **counts}


def _stub_graph(monkeypatch, g, record_runs_body):
    """CUDA stand-ins on one StepGraph: no side stream; the capture runs the
    body's Python once (as a capture does, launching nothing) or not at
    all; a replay is recorded and does nothing."""
    replays = []
    monkeypatch.setattr(g, '_side_stream', contextlib.nullcontext)

    def record():
        if record_runs_body:
            g.body(g.generators)
        return types.SimpleNamespace(reset=lambda: None)
    monkeypatch.setattr(g, '_record', record)
    monkeypatch.setattr(g, '_replay', lambda: replays.append(1))
    return replays


def test_replays_add_the_captured_launches(counters, monkeypatch):
    """The warm-up step counts its own launches, the capture's are taken
    back and every replay adds them: the counts read as if each step had
    run eagerly."""
    def body(generators):
        kernels.count('vq_argmin')
        kernels.count('adam', 20)
        kernels.count('ema')
        kernels.count('recon', 2)
    g = graphs.StepGraph(body, 'cpu', capture=True)
    replays = _stub_graph(monkeypatch, g, True)
    g.run(5)
    assert kernels.counts() == _launches(vq_argmin=5, adam=100, ema=5,
                                         recon=10)
    assert g.launches == _launches(vq_argmin=1, adam=20, ema=1, recon=2)
    assert len(replays) == 4
    g.run(3)
    eight = _launches(vq_argmin=8, adam=160, ema=8, recon=16)
    assert kernels.counts() == eight and len(replays) == 7
    g.run(0)
    assert kernels.counts() == eight


def test_reset_zeroes_every_named_counter(counters):
    """`counts` reads every registered counter, zeros included, in the
    order the wrappers registered them (the reports' key order); `add`
    adds deltas by name, `since` and `restore` take a read as a snapshot,
    and `reset` sets every counter to 0."""
    names = list(kernels.counts())
    assert names[:6] == ['vq_argmin', 'vq_argmin_bf16', 'adam', 'adam_bf16',
                         'ema', 'recon']
    kernels.add({name: i + 1 for i, name in enumerate(names)}, steps=3)
    assert kernels.counts() == {name: 3 * (i + 1)
                                for i, name in enumerate(names)}
    before = kernels.counts()
    kernels.count('recon', 2)
    assert kernels.since(before) == _launches(recon=2)
    kernels.restore(before)
    assert kernels.counts() == before
    kernels.reset()
    assert kernels.counts() == dict.fromkeys(names, 0)


def test_a_new_kernel_is_counted_with_no_edit_here(counters, monkeypatch):
    """A kernel registered with `ops/kernels.py` (a test-only name) is in a
    StepGraph's replay deltas, the full read and the builds, with
    `graphs.py` as it is: a new kernel touches only its wrapper."""
    kernels.register(lambda: None, 'test_only')
    with pytest.raises(ValueError, match='taken'):
        kernels.register(lambda: None, 'test_only')

    def body(generators):
        kernels.count('test_only', 3)
    g = graphs.StepGraph(body, 'cpu', capture=True)
    _stub_graph(monkeypatch, g, True)
    g.run(4)
    assert g.launches == _launches(test_only=3)
    assert kernels.counts() == _launches(test_only=12)
    assert list(kernels.counts())[-1] == 'test_only'
    assert 'test_only' in kernels.builds()


def test_replays_draw_what_the_eager_loop_draws(monkeypatch):
    """The graph's own generator takes the caller's state before the
    replays and hands it back after them: draws and the caller's final
    state are the eager loop's."""
    draws = []

    def body(generators):
        draws.append(torch.rand(3, generator=generators[0]))
    g = graphs.StepGraph(body, 'cpu', n_generators=1, capture=True)
    _stub_graph(monkeypatch, g, False)
    g._replay = lambda: body(g.generators)
    mine = torch.Generator().manual_seed(5)
    g.run(4, [mine])
    g.run(2, [mine])
    ref = torch.Generator().manual_seed(5)
    assert all(torch.equal(d, torch.rand(3, generator=ref)) for d in draws)
    assert len(draws) == 6
    assert torch.equal(mine.get_state(), ref.get_state())
    with pytest.raises(ValueError, match='1 generators, got 0'):
        g.run(1)


def test_trainer_recaptures_on_a_new_state_or_data(counters, monkeypatch):
    """The trainer keeps one graph an epoch kind, keyed on the addresses
    and shapes of the state and data: the same state and data replay it,
    another state (a copy) or another data tensor capture anew, and `fit`
    releases every graph. The stub replays run the body, so the states stay
    bit-equal to the eager loop's."""
    captured = []
    monkeypatch.setattr(Trainer, '_use_graphs', lambda self: True)
    monkeypatch.setattr(graphs.StepGraph, '_side_stream',
                        lambda self: contextlib.nullcontext())

    def record(self):
        captured.append(self.key[0])
        return types.SimpleNamespace(reset=lambda: None)
    monkeypatch.setattr(graphs.StepGraph, '_record', record)
    monkeypatch.setattr(graphs.StepGraph, '_replay',
                        lambda self: self.body(self.generators))
    y = torch.from_numpy(_data(6))
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    a, ref = tr.init_state(1), tr.init_state(1)
    for epoch in range(2):
        a, _ = tr.run_epoch(a, y, tr.epoch_generator(3, epoch))
        ref, _ = _eager_epoch(tr, ref, y, tr.epoch_generator(3, epoch))
    assert captured == ['epoch']
    _assert_bit_equal(a, ref)
    b, _ = tr.run_epoch(copy_state(a), y, tr.epoch_generator(3, 2))
    assert captured == ['epoch'] * 2
    tr.run_epoch(b, y.clone(), tr.epoch_generator(3, 3))
    assert captured == ['epoch'] * 3
    tr.run_epoch_packed(tr.init_states_packed([1, 2]), y,
                        [tr.epoch_generator(s, 0) for s in (1, 2)])
    assert captured[-1] == 'packed' and set(tr._graphs) == {'epoch',
                                                            'packed'}
    tr.fit(b, y.numpy(), 1, seed=3)
    assert tr._graphs == {}


def test_graphs_share_one_capture_stream_a_device(monkeypatch):
    """Every StepGraph of a device warms up and captures on the device's
    one capture stream (cuBLAS keeps a workspace a (handle, stream) pair
    for the life of the process); another device gets its own. CUDA's
    streams are stand-ins here."""
    made = []

    class Stream:
        def __init__(self, device=None):
            made.append(device)

        def wait_stream(self, other):
            pass
    current = Stream()
    made.clear()
    monkeypatch.setattr(graphs, '_CAPTURE_STREAMS', {})
    monkeypatch.setattr(torch.cuda, 'Stream', Stream)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: current)
    monkeypatch.setattr(torch.cuda, 'stream',
                        lambda stream: contextlib.nullcontext())
    streams = []
    for device in ('cuda', 'cuda:0', 'cuda:0', 'cuda:1'):
        g = graphs.StepGraph(lambda gens: None, device, capture=True)
        with g._side_stream() as stream:
            streams.append(stream)
    assert streams[0] is streams[1] is streams[2]
    assert streams[3] is not streams[0]
    assert made == [0, 1]
    assert graphs.capture_stream('cuda:1') is streams[3]
