"""The port's serving API (PgmModel, get_probability) against a JAX
PgmModel built with its own constructor from the same weights and CPT."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu import gibbs as jg
from pgmvae_tpu import stage2 as js2
from pgmvae_tpu.models import vqvae as jv
from pgmvae_tpu.serving import PgmModel as JaxPgmModel
from pgmvae_tpu_torch import gibbs as tg
from pgmvae_tpu_torch import stage2 as ts2
from pgmvae_tpu_torch.convert import params_from_jax
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.serving import PgmModel

KW = dict(n_var=10, units=(8, 6), dim=3, num_codes=7)


def _data(n_rows, seed):
    rng = np.random.default_rng(seed)
    y = np.zeros((n_rows, KW['n_var']), np.float32)
    y[:, 0] = rng.integers(0, 2, n_rows)
    for v in range(1, KW['n_var']):
        flip = rng.random(n_rows) < 0.15
        y[:, v] = np.where(flip, 1 - y[:, v - 1], y[:, v - 1])
    return y


@pytest.fixture(scope='module', params=[0, 2], ids=['no_parents', 'parents'])
def served(request):
    m = request.param
    jcfg, tcfg = jv.VqVaeConfig(**KW), tv.VqVaeConfig(**KW)
    p, cb = jv.init_model(jax.random.PRNGKey(7), jcfg)
    tp, tcb = params_from_jax(jax.tree.map(np.asarray, p), np.asarray(cb),
                              'cpu')
    y = _data(240, seed=7)
    parents = js2.select_parents(y, m) if m else None
    s2 = js2.Stage2(jcfg, chunk=64, parents=parents)
    dist = s2.cpt(p, cb, y)
    jm = JaxPgmModel(jcfg, p, cb, dist, parents=parents)
    tm = PgmModel(tcfg, tp, tcb, dist, parents=parents, device='cpu')
    return dict(jm=jm, tm=tm, y=y, dist=dist, parents=parents, tcfg=tcfg,
                tp=tp, tcb=tcb)


def test_score_matches_jax_and_stage2(served):
    y = served['y']
    got = served['tm'].score(y)
    assert got.shape == (y.shape[0],) and got.dtype == np.float32
    np.testing.assert_allclose(got, served['jm'].score(y), rtol=1e-5)
    t = ts2.Stage2(served['tcfg'], chunk=64, parents=served['parents'],
                   device='cpu')
    pll = t.pseudo_log_likelihood(served['tp'], served['tcb'], y,
                                  served['dist'])
    np.testing.assert_allclose(got.mean(), pll, rtol=1e-5)


def test_codes_match_jax(served):
    y = served['y'][:50]
    got = served['tm'].codes(y)
    assert got.shape == (50, KW['n_var']) and got.dtype == np.int32
    np.testing.assert_array_equal(got, served['jm'].codes(y))


def test_conditional_probability_matches_jax(served):
    y2 = served['y'][:20]
    y3 = np.stack([served['y'][20:40], served['y'][40:60], served['y'][:20]])
    for y, fts in ((y2, [3]), (y2, [0, 9, 4]), (y3, [1, 5, 8])):
        got = served['tm'].conditional_probability(y, fts)
        assert got.shape == (len(fts), 20)
        np.testing.assert_allclose(
            got, served['jm'].conditional_probability(y, fts), rtol=1e-5)
    # on shared samples it is the CPT cell of the sample's own code
    if served['parents'] is None:
        codes = served['tm'].codes(y2)
        np.testing.assert_array_equal(
            served['tm'].conditional_probability(y2, [3])[0],
            served['dist'][3, codes[:, 3]].astype(np.float32))


def test_get_probability_matches_jax(served):
    y = served['y'][:16]
    fts = np.array([6, 1], np.int32)
    dist32 = served['dist'].astype(np.float32)
    jm = served['jm']
    ref = np.asarray(jg.get_probability(
        jm.params, jm.codebook, jm.cfg, jnp.asarray(dist32),
        jnp.asarray(y), jnp.asarray(fts), parents=jm.parents))
    par = served['parents']
    got = tg.get_probability(
        served['tp'], served['tcb'], served['tcfg'],
        torch.from_numpy(dist32), torch.from_numpy(y),
        torch.from_numpy(fts),
        parents=None if par is None else torch.from_numpy(par))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


# ------------------------------------------------ from_checkpoint --

@pytest.mark.parametrize('quantizer,m', [('ema', 0), ('ema', 2), ('vq', 0),
                                         ('naive', 0)])
def test_from_checkpoint_of_a_jax_file(quantizer, m, tmp_path):
    """A checkpoint the JAX package wrote (with `cpt_parents` in its extra
    for joint-code tables) serves the JAX model's scores, codes and
    conditionals."""
    from pgmvae_tpu import checkpoint as jckpt
    from pgmvae_tpu.train import Trainer as JTrainer
    jcfg = jv.VqVaeConfig(**KW, quantizer=quantizer)
    st = JTrainer(jcfg, 0.01, 8, 240).init_state(jax.random.PRNGKey(5))
    y = _data(240, seed=5)
    parents = js2.select_parents(y, m) if m else None
    s2 = js2.Stage2(jcfg, chunk=64, parents=parents)
    codebook = {'ema': st.ema.codebook if st.ema is not None else None,
                'vq': st.params.get('codebook'), 'naive': None}[quantizer]
    dist = s2.cpt(st.params, codebook, y)
    path = str(tmp_path / 'm.ckpt')
    extra = {'identifier': 'x'}
    if parents is not None:
        extra['cpt_parents'] = parents.tolist()
    jckpt.save(path, jcfg, st, dist, extra=extra)

    jm = JaxPgmModel.from_checkpoint(path)
    tm = PgmModel.from_checkpoint(path, device='cpu')
    assert tm.cfg == tv.VqVaeConfig(**KW, quantizer=quantizer)
    np.testing.assert_allclose(tm.score(y), jm.score(y), rtol=1e-5)
    np.testing.assert_array_equal(tm.codes(y[:50]), jm.codes(y[:50]))
    np.testing.assert_allclose(tm.conditional_probability(y[:20], [0, 9, 4]),
                               jm.conditional_probability(y[:20], [0, 9, 4]),
                               rtol=1e-5)


def test_from_checkpoint_without_dist_raises(tmp_path):
    from pgmvae_tpu import checkpoint as jckpt
    from pgmvae_tpu.train import Trainer as JTrainer
    jcfg = jv.VqVaeConfig(**KW)
    path = str(tmp_path / 'm.ckpt')
    jckpt.save(path, jcfg, JTrainer(jcfg, 0.01, 8, 24).init_state(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match='no CPT'):
        PgmModel.from_checkpoint(path, device='cpu')
