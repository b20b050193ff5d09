"""The port's Trainer against the JAX package's: one train step from a
carried-across JAX `TrainState` on the same batch, the state's round trip,
the trainer's own contracts (mirroring tests/test_train.py), and a short
run of each package on the same data landing in the same PLL band."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.stage2 import Stage2 as JStage2
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch.convert import (train_state_from_jax,
                                      train_state_to_numpy)
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.stage2 import Stage2
from pgmvae_tpu_torch.train import (EpochMetrics, Trainer, copy_state,
                                    epoch_seed)

KW = dict(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25, decay=0.9,
          quantizer='ema')
CFG = tv.VqVaeConfig(**KW)


def _data(n=37, seed=0, n_var=6):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, n_var)).astype(np.float32)


def _leaves(state):
    """Every tensor of a port TrainState as numpy, in a fixed order."""
    out = tv.param_leaves(state.params)
    if state.ema is not None:
        out += list(state.ema)
    opt = state.opt_state
    out += (tv.param_leaves(opt.mu) + tv.param_leaves(opt.nu)
            + [opt.count, opt.learning_rate, state.step])
    return [x.detach().numpy() for x in out]


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------- step against JAX --

@pytest.mark.parametrize('over', [
    {}, {'quantizer': 'vq'}, {'quantizer': 'naive'},
    {'n_var': 8, 'n_active': 6, 'l2_reg': 0.01}])
def test_train_step_matches_jax(over):
    kw = {**KW, **over}
    jcfg, tcfg = JCfg(**kw), tv.VqVaeConfig(**kw)
    jtr = JTrainer(jcfg, 0.01, 8, 37)
    js = jtr.init_state(jax.random.PRNGKey(0))
    y = np.pad(_data(8, seed=1), ((0, 0), (0, jcfg.n_var - 6)))
    w = np.ones(8, np.float32)
    w[5] = 0.0                                   # one weight-0 row
    js_np = jax.tree.map(np.asarray, js)

    tr = Trainer(tcfg, 0.01, 8, 37, device='cpu')
    ts = train_state_from_jax(js_np, tcfg, 'cpu')
    ts2, tm = tr.train_step(ts, torch.from_numpy(y), torch.from_numpy(w))
    js2, jm = jax.jit(jtr.train_step)(js, jnp.asarray(y), jnp.asarray(w))
    js2 = jax.tree.map(np.asarray, js2)

    for i, (got, ref) in enumerate(zip(tv.param_leaves(ts2.params),
                                       jax.tree.leaves(js2.params))):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f'param leaf {i}')
    if tcfg.quantizer == 'ema':
        for f in ('codebook', 'counts', 'dw'):
            np.testing.assert_allclose(getattr(ts2.ema, f).numpy(),
                                       getattr(js2.ema, f), rtol=1e-5,
                                       atol=1e-7, err_msg=f)
        assert int(ts2.ema.step) == int(js2.ema.step) == 1
    inner = js2.opt_state.inner_state[0]
    for name, mine, ref in (('mu', ts2.opt_state.mu, inner.mu),
                            ('nu', ts2.opt_state.nu, inner.nu)):
        for got, r in zip(tv.param_leaves(mine), jax.tree.leaves(ref)):
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-4,
                                       atol=1e-9, err_msg=name)
    assert int(ts2.opt_state.count) == int(inner.count) == 1
    assert int(ts2.step) == int(js2.step) == 1
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5)

    # round trip: numpy in the JAX structure, and back, bit for bit; the
    # JAX package takes it as its own state
    back = train_state_to_numpy(ts2, like=js2)
    assert jax.tree.structure(back) == jax.tree.structure(js2)
    _assert_states_equal(train_state_from_jax(back, tcfg, 'cpu'), ts2)
    js3, _ = jax.jit(jtr.train_step)(jax.tree.map(jnp.asarray, back),
                                     jnp.asarray(y), jnp.asarray(w))
    assert int(js3.step) == 2


def test_train_state_from_jax_checks_the_quantizer():
    jtr = JTrainer(JCfg(**KW), 0.01, 8, 37)
    js = jax.tree.map(np.asarray, jtr.init_state(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match='quantizer'):
        train_state_from_jax(js, CFG._replace(quantizer='vq'), 'cpu')


# ---------------------------------------------------- trainer contracts --

def test_padded_rows_do_not_affect_training():
    """An epoch over N=37 at bs=8 (ragged) equals feeding the same five
    batches by hand, with explicit weights."""
    y = _data(37)
    tr = Trainer(CFG, 0.01, 8, 37, device='cpu')
    state_a, _ = tr.run_epoch(tr.init_state(0), torch.from_numpy(y),
                              tr.epoch_generator(42, 0))
    state_b = tr.init_state(0)
    perm = torch.randperm(37, generator=tr.epoch_generator(42, 0)).numpy()
    for i in range(5):
        idx = perm[i * 8:(i + 1) * 8]
        w = np.ones(8, np.float32)
        if len(idx) < 8:
            w[len(idx):] = 0.0
            idx = np.concatenate([idx, np.zeros(8 - len(idx), np.int64)])
        state_b, _ = tr.train_step(state_b, torch.from_numpy(y[idx]),
                                   torch.from_numpy(w))
    _assert_states_equal(state_a, state_b)


def test_weight_zero_rows_are_inert():
    y = _data(16, seed=1)
    tr = Trainer(CFG, 0.01, 8, 16, device='cpu')
    s0 = tr.init_state(1)
    w = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.float32)
    clean = torch.from_numpy(np.concatenate([y[:4], y[:4]]))
    garbage = torch.from_numpy(np.concatenate(
        [y[:4], 123.0 * np.ones((4, 6), np.float32)]))
    s_clean, m_clean = tr.train_step(copy_state(s0), clean, w)
    s_pad, m_pad = tr.train_step(copy_state(s0), garbage, w)
    np.testing.assert_allclose(m_pad.numpy(), m_clean.numpy(), rtol=1e-6)
    for a, b in zip(_leaves(s_clean), _leaves(s_pad)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_fit_start_epoch_chunks_bitwise_match_single_fit():
    y = _data(41, seed=5)
    tr = Trainer(CFG._replace(dead_code_threshold=0.5), 0.01, 8, 41,
                 device='cpu')
    one, h_one = tr.fit(tr.init_state(3), y, 6, seed=11)
    chunk, h = tr.fit(tr.init_state(3), y, 2, seed=11)
    chunk, h2 = tr.fit(chunk, y, 3, seed=11, start_epoch=2)
    chunk, h3 = tr.fit(chunk, y, 1, seed=11, start_epoch=5)
    _assert_states_equal(one, chunk)
    assert h_one == h + h2 + h3


def test_fixed_seed_is_deterministic_and_logging_reads_the_same():
    y = _data(40, seed=9)
    tr = Trainer(CFG, 0.01, 16, 40, device='cpu')
    s1, h1 = tr.fit(tr.init_state(11), y, 3, seed=11)
    logged = []
    s2, h2 = tr.fit(tr.init_state(11), y, 3, seed=11,
                    log_fn=lambda e, m: logged.append((e, m)))
    _assert_states_equal(s1, s2)
    assert h1 == h2 == [m for _, m in logged]
    assert [e for e, _ in logged] == [0, 1, 2]
    assert all(isinstance(m, EpochMetrics) and isinstance(m.loss, float)
               for m in h1)
    assert epoch_seed(11, 1) != epoch_seed(11, 2) != epoch_seed(12, 2)


def test_loss_decreases():
    y = _data(128, seed=5)
    tr = Trainer(CFG, 0.005, 32, len(y), device='cpu')
    st, hist = tr.fit(tr.init_state(2), y, 30, seed=2)
    assert hist[-1].loss < hist[0].loss * 0.9
    assert hist[-1].mse < 0.25
    assert int(st.step) == 30 * 4 == int(st.opt_state.count)


def test_dead_code_restarts_fire_during_epoch():
    y = torch.from_numpy(_data(32, seed=3))
    base = Trainer(CFG, 0.01, 16, 32, device='cpu')
    st_a, _ = base.run_epoch(base.init_state(1), y, base.epoch_generator(2, 0))
    tr = Trainer(CFG._replace(dead_code_threshold=1e9), 0.01, 16, 32,
                 device='cpu')
    st_b, m = tr.run_epoch(tr.init_state(1), y, tr.epoch_generator(2, 0))
    assert np.isfinite(m.numpy()).all()
    cb = tr.codebook(st_b).numpy()
    assert not np.allclose(base.codebook(st_a).numpy(), cb)
    assert np.isfinite(cb).all()
    # the nearest-code kernel takes contiguous codebooks only
    assert all(t.is_contiguous() for t in st_b.ema)


def test_quantizer_mode_state_layout():
    y = _data()
    tr = Trainer(CFG, 0.01, 8, len(y), device='cpu')
    st = tr.init_state(0)
    assert 'codebook' not in st.params and st.ema is not None
    assert tuple(tr.codebook(st).shape) == (6, 3, 7)
    tr2 = Trainer(CFG._replace(quantizer='vq'), 0.01, 8, len(y), device='cpu')
    st2 = tr2.init_state(0)
    assert 'codebook' in st2.params and st2.ema is None
    before = st2.params['codebook'].clone()
    st2, _ = tr2.run_epoch(st2, torch.from_numpy(y), tr2.epoch_generator(1, 0))
    assert not torch.allclose(before, st2.params['codebook'])
    tr3 = Trainer(CFG._replace(quantizer='naive', dim=20), 0.01, 8, len(y),
                  device='cpu')
    st3 = tr3.init_state(0)
    assert tr3.codebook(st3) is None and st3.ema is None
    _, m = tr3.run_epoch(st3, torch.from_numpy(y), tr3.epoch_generator(1, 0))
    assert float(m[3]) == 0.0          # 2^20 codes: no usage histogram


def test_ema_codebook_update_is_pure_ema():
    from pgmvae_tpu_torch.ops import quantizer as q
    y = torch.from_numpy(_data(16, seed=7))
    tr = Trainer(CFG, 0.01, 16, 16, device='cpu')
    st = tr.init_state(3)
    z = tv.encode(st.params, y)
    counts, dw = q.code_stats(z, q.vq_codes(z, st.ema.codebook), 7)
    expected = q.ema_update(st.ema, counts, dw, CFG.decay, CFG.epsilon,
                            CFG.zero_debias)
    st2, _ = tr.train_step(st, y, torch.ones(16))
    np.testing.assert_allclose(st2.ema.codebook.numpy(),
                               expected.codebook.numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------ run --

def _structured(rows, seed):
    """Binary data over 16 variables driven by 3 hidden factors, so that a
    few epochs learn something."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.5, (3, 16))
    bias = rng.normal(0.0, 1.0, 16)
    h = rng.integers(0, 2, (rows, 3)).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-(h @ logits + bias)))
    return (rng.random((rows, 16)) < p).astype(np.float32)


def test_three_epochs_land_in_the_jax_pll_band():
    """Each package trains from its own RNG, so single runs differ by their
    seeds' spread (about 3% here); the means over three seeds are held to
    2% of each other. Found: JAX -12.66, port -12.57 (0.7%)."""
    kw = dict(n_var=16, units=(15, 14, 13, 12), dim=10, num_codes=50,
              quantizer='ema')
    y_train, y_test = _structured(2000, 0), _structured(300, 1)
    seeds = (0, 1, 2)

    jcfg = JCfg(**kw)
    jtr = JTrainer(jcfg, 0.01, 128, len(y_train))
    j2 = JStage2(jcfg)

    def jpll(st):
        cb = jtr.codebook(st)
        return j2.pseudo_log_likelihood(st.params, cb, y_test,
                                        j2.cpt(st.params, cb, y_train))

    tcfg = tv.VqVaeConfig(**kw)
    tr = Trainer(tcfg, 0.01, 128, len(y_train), device='cpu')
    t2 = Stage2(tcfg, device='cpu')

    def tpll(st):
        cb = tr.codebook(st)
        return t2.pseudo_log_likelihood(st.params, cb, y_test,
                                        t2.cpt(st.params, cb, y_train))

    j_after, t_after = [], []
    for seed in seeds:
        js = jtr.init_state(jax.random.PRNGKey(seed))
        j_before = jpll(js)
        js, _ = jtr.fit(js, y_train, 3, jax.random.PRNGKey(seed))
        j_after.append(jpll(js))
        ts = tr.init_state(seed)
        t_before = tpll(ts)
        ts, _ = tr.fit(ts, y_train, 3, seed=seed)
        t_after.append(tpll(ts))
        assert j_after[-1] > j_before and t_after[-1] > t_before
    j_mean, t_mean = np.mean(j_after), np.mean(t_after)
    assert abs(t_mean - j_mean) < 0.02 * abs(j_mean), (t_after, j_after)
