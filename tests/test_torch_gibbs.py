"""The port's Gibbs CMLL chain (`pgmvae_tpu_torch/gibbs.py`) against the JAX
package's (`pgmvae_tpu/gibbs.py`): fed JAX's own uniforms, uniform(fold_in(
key, i), (blocks, B)) at step i, the port's counts equal JAX's exactly and
its CMLL agrees to 1e-6 relative (the two sum the same float32 terms in
different orders), with and without joint-code parents, with a ragged last
block and across segment boundaries; plus the contracts of
tests/test_gibbs.py."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pgmvae_tpu.gibbs as jg
from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.models import init_model
from pgmvae_tpu.stage2 import select_parents
from pgmvae_tpu_torch import gibbs as tg
from pgmvae_tpu_torch.convert import params_from_jax
from pgmvae_tpu_torch.models import vqvae as tv

KW = dict(n_var=9, units=(8, 6), dim=4, num_codes=5, quantizer='ema')


def _model(seed):
    jcfg = JCfg(**KW)
    p, cb = init_model(jax.random.PRNGKey(seed), jcfg)
    tp, tcb = params_from_jax(jax.tree.map(np.asarray, p), np.asarray(cb),
                              'cpu')
    return jcfg, p, cb, tv.VqVaeConfig(**KW), tp, tcb


def _jax_chain(p, cb, jcfg, dist, x, p1, num_smp, burn_in, key,
               parents=None):
    """JAX's chain as its public function runs it, segment by segment
    (pgmvae_tpu/gibbs.py:143-157): the final counts [B, n]."""
    dist32 = jnp.asarray(np.asarray(dist, np.float32))
    par = None if parents is None else jnp.asarray(parents, jnp.int32)
    batch, n = x.shape
    blocks = math.ceil(n / p1)
    state = jnp.broadcast_to(jnp.asarray(x), (blocks, batch, n))
    cnt = jnp.zeros((batch, n), jnp.float32)
    total, done = num_smp * p1, 0
    while done < total:
        seg = min(jg._SEGMENT_STEPS, total - done)
        state, cnt = jg._cmll_segment(p, cb, jcfg, dist32, state, cnt,
                                      jnp.asarray(done, jnp.int32), p1, seg,
                                      burn_in, key, parents=par)
        done += seg
    return np.asarray(cnt)


def _jax_uniforms(key, blocks, batch):
    def uniform(i):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, i), (blocks, batch))))
    return uniform


@pytest.mark.parametrize('case', ['plain', 'parents', 'segments'])
def test_counts_equal_jax_with_its_uniforms(case, monkeypatch):
    jcfg, p, cb, tcfg, tp, tcb = _model(2)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2, size=(16, 9)).astype(np.float32)
    parents = None
    if case == 'parents':
        parents = select_parents(
            rng.integers(0, 2, size=(200, 9)).astype(np.float32), 2)
        dist = rng.uniform(0.1, 0.9, size=(9, 5, 4))
    else:
        dist = rng.uniform(0.1, 0.9, size=(9, 5))
    if case == 'segments':           # segments that end inside a sweep
        monkeypatch.setattr(jg, '_SEGMENT_STEPS', 7)
        monkeypatch.setattr(tg, 'SEGMENT_STEPS', 7)
    p1, num_smp, burn_in = 4, 30, 5      # 9 variables: blocks of 4, 4, 1
    key = jax.random.PRNGKey(7)
    ref_cnt = _jax_chain(p, cb, jcfg, dist, x, p1, num_smp, burn_in, key,
                         parents)
    ref = jg.conditional_marginal_log_likelihood(
        p, cb, jcfg, dist, x, p1=p1, num_smp=num_smp, burn_in=burn_in,
        key=key, parents=parents)

    chain = tg.GibbsChain(tp, tcb, tcfg, dist, x, p1, burn_in,
                          parents=parents)
    assert (chain.blocks, chain.vol_last) == (3, 1)
    got = chain.sample(num_smp, _jax_uniforms(key, chain.blocks, 16))
    np.testing.assert_array_equal(chain.counts.numpy(), ref_cnt)
    assert ref_cnt.sum() > 0
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


def test_counting_is_strict_after_burn_in():
    """Step burn_in*p1 itself does not count: with num_smp = burn_in + 1
    only the p1 - 1 steps after it do."""
    _, _, _, tcfg, tp, tcb = _model(4)
    x = np.ones((3, 9), np.float32)
    dist = np.full((9, 5), 0.999)         # every draw below it samples 1
    chain = tg.GibbsChain(tp, tcb, tcfg, dist, x, 3, 2)
    chain.run(0, 3 * 3, lambda i: torch.zeros((3, 3)))
    # steps 7 and 8 count, one variable of each block each
    assert float(chain.counts.sum()) == 2 * 3 * 3


def test_uniform_dist_gives_half_marginals():
    """dist = 0.5 everywhere -> chain marginals ~0.5 -> CMLL ~ n*log(0.5)."""
    _, _, _, tcfg, tp, tcb = _model(1)
    dist = np.full((9, 5), 0.5)
    x = np.random.default_rng(1).integers(0, 2, size=(64, 9)).astype(
        np.float32)
    cmll = tg.conditional_marginal_log_likelihood(
        tp, tcb, tcfg, dist, x, p1=3, num_smp=200, burn_in=50,
        generator=torch.Generator().manual_seed(0))
    expect = 9 * np.log(0.5)
    assert abs(cmll - expect) < 0.25, (cmll, expect)


def test_same_generator_seed_same_value():
    _, _, _, tcfg, tp, tcb = _model(2)
    rng = np.random.default_rng(2)
    dist = rng.uniform(0.1, 0.9, size=(9, 5))
    x = torch.from_numpy(rng.integers(0, 2, size=(16, 9)).astype(
        np.float32))

    def run(gen):
        return tg.conditional_marginal_log_likelihood(
            tp, tcb, tcfg, dist, x, p1=4, num_smp=50, burn_in=10,
            generator=gen)
    a = run(torch.Generator().manual_seed(7))
    assert a == run(torch.Generator().manual_seed(7))
    assert np.isfinite(a) and a < 0
    # no generator: one seeded 0
    assert run(None) == run(torch.Generator().manual_seed(0))


def test_verbose_progress(capsys, monkeypatch):
    """verbose prints `cmll sampling step {done}/{total}` after every
    SEGMENT_STEPS steps and at the end, and changes nothing."""
    monkeypatch.setattr(tg, 'SEGMENT_STEPS', 5)
    _, _, _, tcfg, tp, tcb = _model(3)
    rng = np.random.default_rng(3)
    dist = rng.uniform(0.1, 0.9, size=(9, 5))
    x = rng.integers(0, 2, size=(8, 9)).astype(np.float32)

    def run(verbose):
        return tg.conditional_marginal_log_likelihood(
            tp, tcb, tcfg, dist, x, p1=2, num_smp=6, burn_in=2,
            generator=torch.Generator().manual_seed(5), verbose=verbose)
    quiet = run(False)
    assert capsys.readouterr().out == ''
    assert run(True) == quiet
    assert capsys.readouterr().out.splitlines() == [
        'cmll sampling step 5/12', 'cmll sampling step 10/12',
        'cmll sampling step 12/12']
