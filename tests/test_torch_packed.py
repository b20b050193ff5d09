"""Packed seeds in the port against the JAX package's: a packed step from
vmapped JAX states against `jax.vmap` of JAX's step, packed training of each
seed against its unpacked training, `run_packed_experiments` against
`run_experiment` per seed (identifiers pk-S, PLL, select-on-valid), and the
refusals the JAX driver makes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmvae_tpu.driver import ExperimentConfig as JExp
from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch.convert import (train_state_from_jax,
                                      train_state_to_numpy)
from pgmvae_tpu_torch.driver import ExperimentConfig as TExp
from pgmvae_tpu_torch.driver import run_experiment, run_packed_experiments
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.train import Trainer, _map_state

KW = dict(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25, decay=0.9,
          quantizer='ema')
SEEDS = [3, 5, 8]


def _leaves(state):
    out = []
    _map_state(out.append, state)
    return out


@pytest.mark.parametrize('over', [{}, {'quantizer': 'vq'},
                                  {'first_layer': 'rank1', 'l2_reg': 0.01}])
def test_packed_step_matches_jax_vmap(over):
    """One packed step from vmapped JAX states ([S, ...] leaves, converted
    leaf for leaf) against jax.vmap of JAX's train_step on the same
    per-seed batches: float32 tolerance, 1e-5 relative; restarts off."""
    kw = {**KW, **over}
    jcfg, tcfg = JCfg(**kw), tv.VqVaeConfig(**kw)
    jtr = JTrainer(jcfg, 0.01, 8, 37)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    js = jtr.init_states_packed(keys)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, size=(len(SEEDS), 8, 6)).astype(np.float32)
    w = np.ones(8, np.float32)
    w[6:] = 0.0
    js_np = jax.tree.map(np.asarray, js)

    tr = Trainer(tcfg, 0.01, 8, 37, device='cpu')
    ts = train_state_from_jax(js_np, tcfg, 'cpu')
    assert ts.params['enc'][0][0].shape == (3, 6, 6, 5)
    assert ts.opt_state.count.shape == ts.step.shape == (3,)
    ts2, tm = tr.train_step_packed(ts, torch.from_numpy(y),
                                   torch.from_numpy(w))
    js2, jm = jax.jit(jax.vmap(jtr.train_step, in_axes=(0, 0, None)))(
        js, jnp.asarray(y), jnp.asarray(w))
    js2 = jax.tree.map(np.asarray, js2)
    for got, ref in zip(tv.param_leaves(ts2.params),
                        jax.tree.leaves(js2.params), strict=True):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    inner = js2.opt_state.inner_state[0]
    for got, ref in zip(tv.param_leaves(ts2.opt_state.mu),
                        jax.tree.leaves(inner.mu), strict=True):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-9)
    if tcfg.quantizer == 'ema':
        for f in ('codebook', 'counts', 'dw'):
            np.testing.assert_allclose(getattr(ts2.ema, f).numpy(),
                                       getattr(js2.ema, f), rtol=1e-5,
                                       atol=1e-7, err_msg=f)
        assert ts2.ema.step.tolist() == [1, 1, 1]
    assert ts2.step.tolist() == ts2.opt_state.count.tolist() == [1, 1, 1]
    np.testing.assert_allclose(tm.numpy(), np.stack(
        [np.asarray(m) for m in jm], -1), rtol=1e-5)
    # the packed state goes back into the vmapped JAX structure
    back = train_state_to_numpy(ts2, like=js2)
    assert jax.tree.structure(back) == jax.tree.structure(js2)
    for a, b in zip(_leaves(train_state_from_jax(back, tcfg, 'cpu')),
                    _leaves(ts2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('over', [
    {'dead_code_threshold': 0.5},
    {'first_layer': 'rank1', 'dead_code_threshold': 0.5},
    {'quantizer': 'vq', 'l2_reg': 0.01},
    {'compute_dtype': 'bf16'},
])
def test_packed_fit_equals_unpacked_fit_per_seed(over):
    """Packed fit of seed s against an unpacked fit(seed=s): each seed keeps
    its own permutations and restart draws, and only the order of float32
    sums differs, so every leaf agrees to 1e-6 of its largest magnitude;
    the per-seed metrics to 1e-6 relative."""
    cfg = tv.VqVaeConfig(**{**KW, **over})
    y = np.random.default_rng(0).integers(0, 2, (37, 6)).astype(np.float32)
    tr = Trainer(cfg, 0.01, 8, 37, device='cpu')
    states, ms = tr.fit_packed(tr.init_states_packed(SEEDS), y, 3, SEEDS)
    assert ms.loss.shape == (3, 3)
    for s, seed in enumerate(SEEDS):
        ref, hist = tr.fit(tr.init_state(seed), y, 3, seed=seed)
        got = tr.unpack_seed(states, s)
        for a, b in zip(_leaves(got), _leaves(ref), strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            gap = float((a.double() - b.double()).abs().max())
            assert gap <= 1e-6 * float(b.double().abs().max()), gap
        for f, vals in zip(hist[-1]._fields, zip(*hist)):
            np.testing.assert_allclose(getattr(ms, f)[s], vals, rtol=1e-6)
    # the seeds differ: the packed program is not one state broadcast
    assert len({round(float(v), 7) for v in ms.loss[:, -1]}) == 3


def test_unpack_seed_is_a_copy():
    tr = Trainer(tv.VqVaeConfig(**KW), 0.01, 8, 37, device='cpu')
    states = tr.init_states_packed(SEEDS)
    one = tr.unpack_seed(states, 1)
    for a, b in zip(_leaves(one), _leaves(tr.init_state(SEEDS[1]))):
        assert torch.equal(a, b)
    y = np.ones((37, 6), np.float32)
    tr.fit_packed(states, y, 1, SEEDS)
    for a, b in zip(_leaves(one), _leaves(tr.init_state(SEEDS[1]))):
        assert torch.equal(a, b)


def _write_splits(root, rows=(1500, 300, 300), seed=0):
    rng = np.random.default_rng(seed)
    rate = rng.random(16)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < rate).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


BASE = dict(name='nltcs', embedding=8, dim=4, batch=128, epoch=2,
            rate=0.01, ema=True, units=(8, 6))


def test_packed_experiments_match_unpacked_per_seed(tmp_path):
    _write_splits(tmp_path)
    exps = [TExp(**BASE, seed=s, data_dir=str(tmp_path)) for s in (0, 1, 2)]
    packed = run_packed_experiments(exps, device='cpu')
    assert len(packed) == 3
    for exp, pres in zip(exps, packed):
        res = run_experiment(exp, device='cpu')
        assert pres['identifier'] == res['identifier'] + '_pk-3'
        assert pres['identifier'] == JExp(**BASE, seed=exp.seed,
                                          packed_seeds=3).identifier
        for k in ('pll_train', 'pll_valid', 'pll_test'):
            np.testing.assert_allclose(pres[k], res[k], rtol=0, atol=2e-4)
        assert pres['packed_seeds'] == 3 and pres['platform'] == 'cpu'
        assert pres['samples_per_sec_packed'] == pytest.approx(
            3 * pres['samples_per_sec'], rel=1e-3)
    assert len({round(p['pll_test'], 6) for p in packed}) > 1


def test_packed_select_on_valid_matches_unpacked(tmp_path):
    _write_splits(tmp_path)
    exps = [TExp(**{**BASE, 'epoch': 4}, seed=s, select_on_valid=2,
                 data_dir=str(tmp_path)) for s in (0, 1)]
    packed = run_packed_experiments(exps, device='cpu')
    for exp, pres in zip(exps, packed):
        res = run_experiment(exp, device='cpu')
        assert pres['best_epoch'] == res['best_epoch']
        np.testing.assert_allclose(pres['pll_test'], res['pll_test'],
                                   rtol=0, atol=2e-4)


def test_packed_refusals_match_jax():
    with pytest.raises(ValueError, match='differ only in seed'):
        run_packed_experiments([TExp(**BASE, seed=0),
                                TExp(**{**BASE, 'dim': 8}, seed=1)],
                               device='cpu')
    with pytest.raises(ValueError, match='device mesh'):
        run_packed_experiments(
            [TExp(**BASE, seed=s, mesh_data=2) for s in (0, 1)],
            device='cpu')
    with pytest.raises(ValueError, match='unpacked'):
        run_packed_experiments(
            [TExp(**BASE, seed=s, resume='x.ckpt') for s in (0, 1)],
            device='cpu')
    assert run_packed_experiments([], device='cpu') == []
    # a pk-S cell regenerates through the packed path only
    with pytest.raises(ValueError, match='run_packed_experiments'):
        run_experiment(TExp(**BASE, seed=1, packed_seeds=3), device='cpu')
