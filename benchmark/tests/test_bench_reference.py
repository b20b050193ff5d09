"""The plain reference against the port at a small size on the CPU, for
each traffic kind: training steps (loss, first gradient, change, with
dead-code restarts), the stage-2 CPT, a Gibbs step and per-row scores."""

import numpy as np
import pytest
import torch

from benchmark import inputs, program, reference
from benchmark.tests.conftest import TINY_CONFIG

SEED = 4_000_000_007


def _cfg(name):
    return {**inputs.config(name), **TINY_CONFIG}


@pytest.mark.parametrize('name', ['bbc', 'kdd'])
def test_training_steps_agree(name, cpu_threads):
    from pgmvae_tpu_torch.train import Trainer
    cfg = _cfg(name)
    y = torch.as_tensor(inputs.shared_factor_splits(cfg, SEED)['train'])
    batches = [y[t * 10:(t + 1) * 10] for t in range(3)]
    tr = Trainer(program.model_config(cfg), cfg['learning_rate'], 10,
                 y.shape[0], adam_eps=cfg['adam_eps'], device='cpu')
    state = tr.init_state(1)
    w0 = inputs.weights(cfg, SEED, 'cpu')
    program.load_weights(state, w0)
    gen = torch.Generator().manual_seed(9)
    losses = []
    for b in batches:
        state, m = tr.train_step(state, b, torch.ones(10), gen)
        losses.append(float(m[0]))
    ref = reference.train(inputs.weights(cfg, SEED, 'cpu'), cfg, batches,
                          torch.Generator().manual_seed(9))
    np.testing.assert_allclose(losses, ref['loss'], rtol=1e-5)
    leaves = [t for s in ('enc', 'dec') for layer in state.params[s]
              for t in layer]
    start = [t for s in ('enc', 'dec') for layer in w0[s] for t in layer]
    delta = [reference.norms(a - b) for a, b in zip(leaves, start)]
    delta.append(reference.norms(state.ema.codebook - w0['codebook']))
    np.testing.assert_allclose(delta, ref['delta'], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize('name', ['bbc', 'kdd'])
def test_cpt_and_scores_agree(name, cpu_threads):
    from pgmvae_tpu_torch.serving import PgmModel
    from pgmvae_tpu_torch.stage2 import Stage2
    cfg = _cfg(name)
    splits = inputs.shared_factor_splits(cfg, SEED)
    w = inputs.weights(cfg, SEED, 'cpu')
    params, codebook = program.serving_params(w)
    pcfg = program.model_config(cfg)
    dist = Stage2(pcfg, device='cpu').cpt(params, codebook, splits['train'])
    table = reference.cpt(w, cfg, torch.as_tensor(splits['train']))
    assert reference.cpt_cells_off(dist, table) == 0.0
    model = PgmModel(pcfg, params, codebook, dist, device='cpu')
    got = model.score(splits['test'])
    want = reference.score(w, cfg, table,
                           torch.as_tensor(splits['test'])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_gibbs_step_agrees(cpu_threads):
    from pgmvae_tpu_torch.gibbs import GibbsChain
    from pgmvae_tpu_torch.stage2 import Stage2
    cfg = _cfg('kdd')
    splits = inputs.shared_factor_splits(cfg, SEED)
    w = inputs.weights(cfg, SEED, 'cpu')
    params, codebook = program.serving_params(w)
    pcfg = program.model_config(cfg)
    dist = Stage2(pcfg, device='cpu').cpt(params, codebook, splits['train'])
    p1, burn_in = 3, 1
    chain = GibbsChain(params, codebook, pcfg, dist, splits['test'], p1,
                       burn_in)
    blocks, _ = reference.gibbs_layout(cfg['n_var'], p1)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((12, blocks, splits['test'].shape[0]), generator=gen)
    table = reference.cpt(w, cfg, torch.as_tensor(splits['train']))
    for i in range(12):
        state, counts = chain.state.clone(), chain.counts.clone()
        chain.run(i, 1, lambda k: u[k])
        r_state, r_counts = reference.gibbs_step(w, cfg, table, state,
                                                 counts, i, u[i], p1,
                                                 burn_in)
        assert torch.equal(chain.state, r_state)
        assert torch.equal(chain.counts, r_counts)
    assert float(chain.counts.sum()) > 0


def test_tf32_rounding_on_the_cpu():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    assert torch.equal(reference._tf32_round(x),
                       torch.tensor([1.0, 1.0 + 2 ** -10, 3.0]))


@pytest.mark.parametrize('seed,epoch', [(SEED, 0), (2 ** 31 + 5, 3)])
def test_epoch_permutation_agrees(seed, epoch):
    from pgmvae_tpu_torch.train import Trainer
    cfg = _cfg('bbc')
    n, bs = 53, 10
    tr = Trainer(program.model_config(cfg), cfg['learning_rate'], bs, n,
                 device='cpu')
    gen = tr.epoch_generator(seed, epoch)
    perm = tr._padded_perm(gen).reshape(-1)[:n]
    ref, ref_gen = reference.epoch_permutation(seed, epoch, n, 'cpu')
    assert torch.equal(perm, ref)
    # the restarts draw next from the same stream
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=ref_gen))

