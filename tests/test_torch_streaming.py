"""Streaming epochs (`Trainer.fit` past `stream_bytes`, the port of the JAX
package's `_fit_streaming`): a streamed fit is bit-equal to an in-core fit
on the same device, whatever the chunking, with dead-code restarts, across
`start_epoch` and through the `log_fn` path."""

import inspect

import numpy as np
import pytest
import torch

from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.train import Trainer, _map_state

CFG = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25,
                     decay=0.9, quantizer='ema')
N, BS = 37, 8            # 5 steps an epoch, the last one ragged
ROW = BS * 6 * 4         # bytes of one batch


def _leaves(state):
    out = []
    _map_state(out.append, state)
    return out


def _assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(N, 6)).astype(np.float32)


def test_stream_arguments_match_jax():
    """`Trainer.__init__` takes the JAX package's stream_bytes and
    stream_chunk_bytes, with its defaults."""
    mine = inspect.signature(Trainer.__init__).parameters
    ref = inspect.signature(JTrainer.__init__).parameters
    for name in ('stream_bytes', 'stream_chunk_bytes'):
        assert mine[name].default == ref[name].default
    tr = Trainer(CFG, 0.01, BS, N, device='cpu')
    assert (tr.stream_bytes, tr.stream_chunk_bytes) == (4 << 30, 64 << 20)


@pytest.mark.parametrize('chunk_steps,over', [
    (1, {}),                                  # one step a chunk
    (2, {}),                                  # the last chunk ragged
    (5, {}),                                  # the whole epoch at once
    (64, {}),                                 # capped at the epoch's steps
    (2, {'dead_code_threshold': 0.5}),        # restarts draw in order
    (3, {'quantizer': 'vq', 'first_layer': 'rank1'}),
    (2, {'compute_dtype': 'bf16'}),
])
def test_streamed_fit_is_bit_equal_to_in_core(chunk_steps, over):
    cfg = CFG._replace(**over)
    y = _data()
    core = Trainer(cfg, 0.01, BS, N, device='cpu')
    streamed = Trainer(cfg, 0.01, BS, N, stream_bytes=y.nbytes - 1,
                       stream_chunk_bytes=chunk_steps * ROW, device='cpu')
    a, ha = core.fit(core.init_state(3), y, 3, seed=7)
    b, hb = streamed.fit(streamed.init_state(3), y, 3, seed=7)
    assert ha == hb
    _assert_bit_equal(a, b)


def test_streamed_start_epoch_composes_and_logs():
    """fit(2) then fit(1, start_epoch=2), streamed and logged, is bit-equal
    to one in-core fit(3); log_fn sees the same epochs and metrics."""
    y = _data(1)
    cfg = CFG._replace(dead_code_threshold=0.5)
    core = Trainer(cfg, 0.01, BS, N, device='cpu')
    streamed = Trainer(cfg, 0.01, BS, N, stream_bytes=0,
                       stream_chunk_bytes=2 * ROW, device='cpu')
    logged = []

    def log_fn(epoch, m):
        logged.append((epoch, m))
    whole, hist = core.fit(core.init_state(0), y, 3, seed=4)
    part, h1 = streamed.fit(streamed.init_state(0), y, 2, seed=4,
                            log_fn=log_fn)
    part, h2 = streamed.fit(part, y, 1, seed=4, log_fn=log_fn,
                            start_epoch=2)
    _assert_bit_equal(whole, part)
    assert h1 + h2 == hist
    assert [e for e, _ in logged] == [0, 1, 2]
    assert [m for _, m in logged] == hist


def test_host_batches_are_the_in_core_batches():
    """The chunked host gather yields, batch for batch, what the in-core
    epoch takes from the device (sentinel rows read row 0): chunks of 2, 2
    and 1 steps."""
    y = _data(2)
    tr = Trainer(CFG, 0.01, BS, N, stream_chunk_bytes=2 * ROW, device='cpu')
    perm = tr._padded_perm(tr.epoch_generator(5, 0))
    data = torch.from_numpy(y)
    want = [data.index_select(0, torch.clamp(idx, min=0)) for idx in perm]
    chunks = [c.clone() for c in tr._host_chunks(y, perm.numpy())]
    assert [c.shape[0] for c in chunks] == [2, 2, 1]
    got = [b for c in chunks for b in c]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
