"""Stage 2 fed from the host in pinned pieces (`Stage2.counts`,
`data.pinned`): with PIECE_BYTES cut so that a piece holds 1, 2 or 3
chunks, the port's counts (its one path) stay bit-equal to the JAX
package's `Stage2(cfg, chunk=c).counts` (both of its paths, one-hot and
scatter; a padded variable axis, a split shorter than one chunk), and no
host-to-device transfer is larger than one piece."""

import jax
import numpy as np
import pytest
import torch

from pgmvae_tpu import stage2 as js2
from pgmvae_tpu.models import vqvae as jv
from pgmvae_tpu_torch import stage2 as ts2
from pgmvae_tpu_torch.convert import params_from_jax
from pgmvae_tpu_torch.data import pinned
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.train import Trainer

CHUNK = 16
ROWS = 7 * CHUNK + 5           # 8 chunks, the last ragged


def _models(seed, **kw):
    base = dict(n_var=8, units=(8, 6), dim=3, num_codes=6)
    base.update(kw)
    jcfg, tcfg = jv.VqVaeConfig(**base), tv.VqVaeConfig(**base)
    p, cb = jv.init_model(jax.random.PRNGKey(seed), jcfg)
    tp, tcb = params_from_jax(jax.tree.map(np.asarray, p),
                              None if cb is None else np.asarray(cb), 'cpu')
    return jcfg, tcfg, p, cb, tp, tcb


def _data(n, width=8, seed=0):
    """y_v copies y_{v-1} with flip probability 0.1."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n, width), np.float32)
    y[:, 0] = rng.integers(0, 2, n)
    for v in range(1, width):
        flip = rng.random(n) < 0.1
        y[:, v] = np.where(flip, 1 - y[:, v - 1], y[:, v - 1])
    return y


# (model overrides, Stage2 overrides, rows), named for the JAX package's
# path: its one-hot path, its scatter path (K * 2^m = 72 * 128, past its
# 8,192 columns), a padded variable axis (10 networks, 8 columns of data)
# and a split shorter than one chunk
CASES = {
    'onehot': (dict(), dict(), ROWS),
    'onehot_parents': (dict(), dict(parents=2), ROWS),
    'scatter': (dict(num_codes=72), dict(parents=7), ROWS),
    'padded_axis': (dict(n_var=10, n_active=8), dict(parents=2), ROWS),
    'short_split': (dict(), dict(), CHUNK - 5),
}


def _piece_bytes(chunks, n_var):
    return chunks * CHUNK * n_var * 4


@pytest.mark.parametrize('chunks', [1, 2, 3])
@pytest.mark.parametrize('case', sorted(CASES))
def test_counts_in_pieces_bit_equal_to_jax(case, chunks, monkeypatch):
    model_kw, s2_kw, rows = CASES[case]
    jcfg, tcfg, p, cb, tp, tcb = _models(seed=chunks, **model_kw)
    y = _data(rows, seed=chunks)
    s2_kw = dict(s2_kw)
    if 'parents' in s2_kw:
        s2_kw['parents'] = js2.select_parents(y, s2_kw['parents'])
    # a byte short of the next chunk: pieces hold `chunks` whole chunks
    monkeypatch.setattr(ts2, 'PIECE_BYTES',
                        _piece_bytes(chunks + 1, tcfg.n_var) - 1)
    sent = []
    monkeypatch.setattr(pinned, 'upload',
                        lambda host, out: sent.append(host.shape) or host)
    j = js2.Stage2(jcfg, chunk=CHUNK, **s2_kw)
    t = ts2.Stage2(tcfg, chunk=CHUNK, device='cpu', **s2_kw)
    assert j.scatter == (case == 'scatter') and t.chunk == j.chunk
    jn1, jn0 = j.counts(p, cb, y)
    tn1, tn0 = t.counts(tp, tcb, y)
    np.testing.assert_array_equal(tn1, jn1)
    np.testing.assert_array_equal(tn0, jn0)
    assert tn1.sum() + tn0.sum() == rows * tcfg.active_vars
    n_chunks = -(-rows // CHUNK)
    per_piece = min(chunks, n_chunks)
    assert len(sent) == -(-n_chunks // per_piece)
    assert all(s == (per_piece * CHUNK, tcfg.n_var) for s in sent[:-1])
    assert sent[-1][0] == (n_chunks - (len(sent) - 1) * per_piece) * CHUNK


def test_one_piece_split_is_one_transfer(monkeypatch):
    """At the default PIECE_BYTES a small split is sent once, as the
    padded split it was before (whole chunks, the ragged tail zero)."""
    _, tcfg, _, _, tp, tcb = _models(seed=3)
    y = _data(ROWS, seed=3)
    sent = []

    def record(host, out):
        sent.append(host.clone())
        return host
    monkeypatch.setattr(pinned, 'upload', record)
    t = ts2.Stage2(tcfg, chunk=CHUNK, device='cpu')
    n1, n0 = t.counts(tp, tcb, y)
    assert len(sent) == 1
    want = np.zeros((8 * CHUNK, tcfg.n_var), np.float32)
    want[:ROWS] = y
    np.testing.assert_array_equal(sent[0].numpy(), want)
    assert n1.sum() + n0.sum() == ROWS * tcfg.n_var


def test_no_transfer_exceeds_a_piece(monkeypatch):
    """Many pieces: every transfer at most PIECE_BYTES, the pieces in
    order and together the split (padded only in its last chunk), and
    counts bit-equal to one piece's."""
    _, tcfg, _, _, tp, tcb = _models(seed=4)
    y = _data(20 * CHUNK + 3, seed=4)
    ref = ts2.Stage2(tcfg, chunk=CHUNK, device='cpu').counts(tp, tcb, y)
    limit = _piece_bytes(3, tcfg.n_var)
    monkeypatch.setattr(ts2, 'PIECE_BYTES', limit)
    sent = []

    def record(host, out):
        sent.append(host.clone())
        return host
    monkeypatch.setattr(pinned, 'upload', record)
    got = ts2.Stage2(tcfg, chunk=CHUNK, device='cpu').counts(tp, tcb, y)
    assert len(sent) == 7 and max(s.numel() * 4 for s in sent) <= limit
    whole = torch.cat(sent).numpy()
    np.testing.assert_array_equal(whole[:y.shape[0]], y)
    assert whole.shape[0] == 21 * CHUNK and not whole[y.shape[0]:].any()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_counts_take_other_dtypes():
    """float64 and bool samples count as their float32 values."""
    _, tcfg, _, _, tp, tcb = _models(seed=5)
    y = _data(ROWS, seed=5)
    s2 = ts2.Stage2(tcfg, chunk=CHUNK, device='cpu')
    ref = s2.counts(tp, tcb, y)
    for other in (y.astype(np.float64), y.astype(bool)):
        for a, b in zip(s2.counts(tp, tcb, other), ref):
            np.testing.assert_array_equal(a, b)


def test_piece_bytes_is_the_trainers_chunk_default():
    tr = Trainer(tv.VqVaeConfig(n_var=4, units=(3,), dim=2, num_codes=3),
                 0.01, 8, 16, device='cpu')
    assert ts2.PIECE_BYTES == tr.stream_chunk_bytes == 64 << 20


@pytest.mark.parametrize('count', [0, 1, 2, 5])
def test_pinned_pieces_in_order(count):
    """The helper yields fill's pieces in order from two alternating
    buffers, which start zeroed: the columns fill never writes stay
    zero."""
    seen = []

    def fill(c, buf):
        assert buf.shape == (4, 3)
        buf[:c % 4 + 1, :2] = float(c + 1)
        return buf[:c % 4 + 1]
    for c, piece in enumerate(pinned.pinned_pieces(
            count, (4, 3), torch.float32, torch.device('cpu'), fill)):
        assert piece.shape == (c % 4 + 1, 3)
        assert bool((piece[:, :2] == c + 1).all())
        assert not bool(piece[:, 2].any())
        seen.append(piece.data_ptr())
    assert len(seen) == count
    assert len(set(seen)) == min(count, 2)
