"""The port's stage 2 (counts, CPT, PLL, parents, mixtures) against the JAX
package's, with weights carried across by `params_from_jax`. Counts are
integers, so the two must agree bit for bit; CPT and PLL are finished in
float64 from equal counts, so they agree to 1e-12. The port counts by one
path (`index_add_`); the cases hold it against each of the JAX package's
two (its one-hot einsum and, with `scatter=True`, its scatter-add)."""

import numpy as np
import jax
import pytest
import torch

from pgmvae_tpu import stage2 as js2
from pgmvae_tpu.models import vqvae as jv
from pgmvae_tpu_torch import stage2 as ts2
from pgmvae_tpu_torch.convert import params_from_jax
from pgmvae_tpu_torch.models import vqvae as tv


def _chain_data(n=8, n_samples=300, seed=0):
    """y_v copies y_{v-1} with flip probability 0.1."""
    rng = np.random.default_rng(seed)
    y = np.zeros((n_samples, n), np.float32)
    y[:, 0] = rng.integers(0, 2, n_samples)
    for v in range(1, n):
        flip = rng.random(n_samples) < 0.1
        y[:, v] = np.where(flip, 1 - y[:, v - 1], y[:, v - 1])
    return y


def _models(seed=0, **kw):
    base = dict(n_var=8, units=(8, 6), dim=3, num_codes=6)
    base.update(kw)
    jcfg, tcfg = jv.VqVaeConfig(**base), tv.VqVaeConfig(**base)
    p, cb = jv.init_model(jax.random.PRNGKey(seed), jcfg)
    tp, tcb = params_from_jax(jax.tree.map(np.asarray, p),
                              None if cb is None else np.asarray(cb), 'cpu')
    return jcfg, tcfg, p, cb, tp, tcb


# (model overrides, Stage2 overrides, the JAX package's path): every case
# but 'scatter' takes its one-hot einsum
CASES = {
    'plain': (dict(), dict(), dict()),
    'parents_m3': (dict(), dict(parents=3), dict()),
    'scatter': (dict(), dict(parents=2), dict(scatter=True)),
    'naive': (dict(quantizer='naive'), dict(), dict()),
    'padded_n_active': (dict(n_var=10, n_active=8), dict(parents=2), dict()),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_counts_bit_equal_to_jax(case):
    model_kw, s2_kw, jax_kw = CASES[case]
    jcfg, tcfg, p, cb, tp, tcb = _models(seed=1, **model_kw)
    y = _chain_data(seed=1, n_samples=333)           # ragged against chunk=64
    s2_kw = dict(s2_kw)
    if 'parents' in s2_kw:
        s2_kw['parents'] = js2.select_parents(y, s2_kw['parents'])
    j = js2.Stage2(jcfg, chunk=64, **s2_kw, **jax_kw)
    t = ts2.Stage2(tcfg, chunk=64, device='cpu', **s2_kw)
    assert j.scatter == (case == 'scatter')
    assert (t.k, t.n_states, t.chunk) == (j.k, j.n_states, j.chunk)
    jn1, jn0 = j.counts(p, cb, y)
    tn1, tn0 = t.counts(tp, tcb, y)
    assert tn1.dtype == np.float64 and tn1.shape == jn1.shape
    assert tn1.sum() + tn0.sum() == y.shape[0] * tcfg.active_vars
    np.testing.assert_array_equal(tn1, jn1)
    np.testing.assert_array_equal(tn0, jn0)

    jd = j.cpt(p, cb, y)
    td = t.cpt(tp, tcb, y)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-12)
    jpll, jper = j.pll_detail(p, cb, y, jd)
    tpll, tper = t.pll_detail(tp, tcb, y, td)
    assert abs(tpll - jpll) <= 1e-12
    np.testing.assert_allclose(tper, jper, rtol=0, atol=1e-12)
    assert t.pseudo_log_likelihood(tp, tcb, y, td) == tpll


def test_counts_at_the_widest_joint_table_match_a_float64_histogram():
    """m = 12 parents, the most `--cpt-parents` allows (K * 4096 cells a
    variable): the counts equal a float64 `np.add.at` histogram of the same
    codes at cells worked out in numpy, ragged last chunk included."""
    n, m = 16, 12
    _, tcfg, _, _, tp, tcb = _models(seed=2, n_var=n)
    y = _chain_data(n=n, seed=2, n_samples=300)
    parents = ts2.select_parents(y, m)
    s2 = ts2.Stage2(tcfg, chunk=64, parents=parents, device='cpu')
    n1, n0 = s2.counts(tp, tcb, y)
    codes = tv.encode_codes(tp, tcb, torch.as_tensor(y), tcfg).numpy()
    words = (y[:, parents].astype(np.int64) << np.arange(m)).sum(-1).T
    cells = codes.astype(np.int64) * (1 << m) + words            # [n, B]
    k = tcfg.effective_codes
    for got, labels in ((n1, y.T), (n0, 1.0 - y.T)):
        want = np.zeros((n, k << m))
        np.add.at(want, (np.arange(n)[:, None], cells),
                  labels.astype(np.float64))
        assert got.shape == (n, k, 1 << m)
        np.testing.assert_array_equal(got.reshape(n, -1), want)
    assert n1.sum() + n0.sum() == y.shape[0] * n


def test_slice_init_in_jax_three_splits():
    """init in JAX -> params_from_jax -> cpt -> PLL on train/valid/test,
    in both packages, equal to 1e-9."""
    jcfg, tcfg, p, cb, tp, tcb = _models(seed=3, n_var=12, units=(10, 8),
                                         dim=4, num_codes=10)
    splits = {s: _chain_data(n=12, n_samples=r, seed=i)
              for i, (s, r) in enumerate((('train', 500), ('valid', 120),
                                          ('test', 150)))}
    j = js2.Stage2(jcfg)
    t = ts2.Stage2(tcfg, device='cpu')
    assert t.chunk == j.chunk
    jd = j.cpt(p, cb, splits['train'])
    td = t.cpt(tp, tcb, splits['train'])
    for y in splits.values():
        jp = j.pseudo_log_likelihood(p, cb, y, jd)
        tp_ = t.pseudo_log_likelihood(tp, tcb, y, td)
        assert np.isfinite(tp_) and abs(tp_ - jp) <= 1e-9, (tp_, jp)


@pytest.mark.parametrize('m', [1, 2, 4])
def test_select_parents_and_mi_exact(m):
    y = _chain_data(n=9, n_samples=400, seed=4)
    y[:, 4] = 1.0                                   # a constant column
    np.testing.assert_array_equal(ts2.mutual_information_matrix(y),
                                  js2.mutual_information_matrix(y))
    got = ts2.select_parents(y, m)
    assert got.dtype == np.int32 and got.shape == (9, m)
    np.testing.assert_array_equal(got, js2.select_parents(y, m))


def test_compose_mixed_cpt_exact():
    rng = np.random.default_rng(5)
    n, k = 6, 4
    dists = {0: rng.random((n, k)), 1: rng.random((n, k, 2)),
             2: rng.random((n, k, 4))}
    parents = {0: None, 1: rng.integers(0, n, (n, 1)).astype(np.int32),
               2: rng.integers(0, n, (n, 2)).astype(np.int32)}
    for sel in ([0, 1, 2, 2, 1, 0], [0] * 6, [1] * 6):
        sel = np.asarray(sel, np.int32)
        gd, gp = ts2.compose_mixed_cpt(dists, parents, sel)
        rd, rp = js2.compose_mixed_cpt(dists, parents, sel)
        np.testing.assert_array_equal(gd, rd)
        if rp is None:
            assert gp is None
        else:
            np.testing.assert_array_equal(gp, rp)


@pytest.mark.parametrize('n_var,k', [(16, 50), (1058, 50), (1058, 800),
                                     (3, 2), (1556, 4096)])
def test_auto_chunk_and_constants_match_jax(n_var, k):
    assert ts2.auto_chunk(n_var, k) == js2.auto_chunk(n_var, k)
    for name in ('SMOOTHING', 'LOG_EPS', 'MAX_COUNT_BYTES',
                 'NAIVE_STAGE2_MAX_DIM'):
        assert getattr(ts2, name) == getattr(js2, name)


def test_stage2_guards_match_jax():
    y = _chain_data(n=6, n_samples=64, seed=6)
    big = tv.VqVaeConfig(n_var=1024, units=(4, 3), dim=2, num_codes=65536)
    with pytest.raises(ValueError, match='GiB'):
        ts2.Stage2(big, parents=np.zeros((1024, 12), np.int32), device='cpu')
    with pytest.raises(ValueError, match=r'\[1, 12\]'):
        ts2.Stage2(big, parents=np.zeros((1024, 13), np.int32), device='cpu')
    with pytest.raises(ValueError, match='dim >'):
        ts2.Stage2(tv.VqVaeConfig(n_var=4, units=(3,), dim=21, num_codes=2,
                                  quantizer='naive'), device='cpu')
    # one count path, so the chunk budget never sees the joint width: the
    # JAX package's chunk wherever it scatters (past 8,192 joint columns)
    kw = dict(n_var=5, units=(4, 3), dim=2, num_codes=1024)
    wide, jwide = tv.VqVaeConfig(**kw), jv.VqVaeConfig(**kw)
    par = ts2.select_parents(y[:, :5], 4)
    for parents in (None, par):
        assert ts2.Stage2(wide, parents=parents, device='cpu').chunk == \
            js2.Stage2(jwide, parents=parents).chunk == ts2.auto_chunk(5, 1024)
