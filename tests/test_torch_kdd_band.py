"""The port against the JAX package at the kdd sweep's shape (n_var 64,
units 50_40_30_20, D=10, K=4096, batch 32, lr 2e-4, cost 0.35, EMA): one
epoch of 200 steps over 6,400 rows whose columns are driven by shared
latent factors (one loading for both splits, as `scripts/synth_kdd.py`
draws them), so that stage 2 sees what training learned. Each package
trains from its own RNG; both must move the test PLL up from their initial
model's, and their means over two seeds must lie within half a nat of each
other. Found: JAX -34.39 -> -33.35, port -34.43 -> -33.57 (the two seeds'
spread is about 0.5 nat)."""

import numpy as np
import jax

from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.stage2 import Stage2 as JStage2
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.stage2 import Stage2
from pgmvae_tpu_torch.train import Trainer

KW = dict(n_var=64, units=(50, 40, 30, 20), dim=10, num_codes=4096,
          cost=0.35, quantizer='ema')
ROWS, TEST_ROWS, BATCH, LR = 6400, 2000, 32, 2e-4
SEEDS = (5, 6)


def _shared_factor_rows(rng, loading, rows):
    """Sparse correlated binary rows: 16 latent Bernoulli factors, each
    turning on its variables of `loading` [16, n_var], with 2% noise."""
    z = rng.random((rows, loading.shape[0])) < 0.2
    y = (z.astype(np.uint8) @ loading.astype(np.uint8)) > 0
    noise = rng.random((rows, loading.shape[1])) < 0.02
    return (y ^ noise).astype(np.float32)


def test_one_kdd_epoch_lands_in_the_jax_pll_band():
    rng = np.random.default_rng(0)
    loading = rng.random((16, KW['n_var'])) < 0.12
    y_train = _shared_factor_rows(rng, loading, ROWS)
    y_test = _shared_factor_rows(rng, loading, TEST_ROWS)

    jcfg = JCfg(**KW)
    jtr, j2 = JTrainer(jcfg, LR, BATCH, ROWS), JStage2(jcfg)
    tcfg = tv.VqVaeConfig(**KW)
    tr, t2 = Trainer(tcfg, LR, BATCH, ROWS, device='cpu'), Stage2(
        tcfg, device='cpu')

    def pll(s2, params, cb):
        return s2.pseudo_log_likelihood(params, cb, y_test,
                                        s2.cpt(params, cb, y_train))

    j_after, t_after = [], []
    for seed in SEEDS:
        js = jtr.init_state(jax.random.PRNGKey(seed))
        j_before = pll(j2, js.params, jtr.codebook(js))
        js, _ = jtr.fit(js, y_train, 1, jax.random.PRNGKey(seed))
        j_after.append(pll(j2, js.params, jtr.codebook(js)))
        ts = tr.init_state(seed)
        t_before = pll(t2, ts.params, tr.codebook(ts))
        ts, _ = tr.fit(ts, y_train, 1, seed=seed)
        t_after.append(pll(t2, ts.params, tr.codebook(ts)))
        assert int(ts.step) == ROWS // BATCH
        # training moves the PLL (measured 0.54-1.18 nat)
        assert j_after[-1] > j_before + 0.25, (j_before, j_after)
        assert t_after[-1] > t_before + 0.25, (t_before, t_after)
    assert abs(np.mean(t_after) - np.mean(j_after)) < 0.5, (t_after,
                                                             j_after)
