"""The port's driver and command line against the JAX package's: the same
ExperimentConfig fields, checks and identifiers, a lossless
parse_identifier, a `result.txt` line whose identifier is the JAX one,
select-on-valid and post-hoc joint-CPT records, and checkpoints, --resume,
--cmll and the `.mix` mixture checkpoint on synthetic nltcs-shaped
splits."""

import dataclasses
import os

import numpy as np
import pytest

from pgmvae_tpu.driver import ExperimentConfig as JExp
from pgmvae_tpu.driver import run_experiment as jrun_experiment
from pgmvae_tpu.utils.logging import parse_identifier as jparse
from pgmvae_tpu.utils.logging import run_identifier as jrun_identifier
from pgmvae_tpu_torch import run as trun
from pgmvae_tpu_torch.driver import ExperimentConfig as TExp
from pgmvae_tpu_torch.driver import run_experiment, unported
from pgmvae_tpu_torch.utils.logging import parse_identifier, run_identifier

BASE = dict(name='nltcs', embedding=50, dim=10)
GRID = [
    {},
    dict(batch=128, epoch=100, rate=0.01, cost=0.25, ema=True, seed=1,
         adam_impl='pallas'),
    dict(adam_impl='fused', note='run-a'),
    dict(adam_impl='fused_bf16', compute_dtype='bf16'),
    dict(name='bbc', embedding=50, dim=20, batch=250, epoch=600, rate=0.003,
         cost=0.05, ema=True, decay=0.9, dead_code_threshold=0.25,
         fan_mode='per_network', select_on_valid=50),
    dict(quantizer='naive', units=(8, 6), zero_debias=False,
         precision='highest', activation='gelu', l2_reg=0.001),
    dict(cpt_parents=3, cpt_parents_eval=(1, 4), cpt_parents_mix=True,
         first_layer='rank1', packed_seeds=3),
]


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JExp)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TExp)]
    assert tf == jf


@pytest.mark.parametrize('over', GRID)
def test_identifier_equals_jax(over):
    kw = {**BASE, **over}
    ident = TExp(**kw).identifier
    assert ident == JExp(**kw).identifier
    assert parse_identifier(ident) == jparse(ident)
    assert TExp(**parse_identifier(ident)).identifier == ident


@pytest.mark.parametrize('over,match', [
    (dict(cpt_parents=13), 'cpt_parents'),
    (dict(cpt_parents_eval=(2, -1)), 'cpt_parents_eval'),
    (dict(cpt_parents_mix=True), 'cpt-parents-eval'),
])
def test_config_checks_match_jax(over, match):
    for cls in (JExp, TExp):
        with pytest.raises(ValueError, match=match):
            cls(**BASE, **over)


def test_run_identifier_refuses_ambiguous_notes_as_jax_does():
    for fn in (run_identifier, jrun_identifier):
        with pytest.raises(ValueError, match='ambiguous'):
            fn('nltcs', 50, 10, 128, 100, 0.01, 0.25, True, 0.99, 1,
               note='x_pk-3')


def _write_splits(root, rows=(600, 200, 200), seed=0):
    """nltcs-shaped splits (16 columns) in the TRW format: one row of
    comma-separated 0/1 per line."""
    rng = np.random.default_rng(seed)
    rate = rng.random(16)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < rate).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


def test_cli_writes_the_jax_identifier(tmp_path, monkeypatch):
    _write_splits(tmp_path)
    monkeypatch.chdir(tmp_path)
    flags = ['-n', 'nltcs', '-k', '50', '-d', '10', '-b', '128', '-e', '2',
             '-r', '0.01', '-c', '0.25', '-m', '-s', '1',
             '--adam-impl', 'pallas']
    rc = trun.main(flags + ['--device', '-1', '--data-dir', str(tmp_path),
                            '--result-file', str(tmp_path / 'result.txt')])
    assert rc == 0
    lines = (tmp_path / 'result.txt').read_text().splitlines()
    assert len(lines) == 1
    ident, rest = lines[0].split(' ', 1)
    assert ident == jrun_identifier('nltcs', 50, 10, 128, 2, 0.01, 0.25,
                                    True, 0.99, 1, adam_impl='pallas')
    assert ident.endswith('_ad-pallas')
    fields = dict(kv.split(':') for kv in rest.split())
    assert set(fields) == {'pll-train', 'pll-valid', 'pll-test', 'cmll-test'}
    assert all(np.isfinite(float(fields[k])) and float(fields[k]) < 0
               for k in ('pll-train', 'pll-valid', 'pll-test'))
    assert fields['cmll-test'] == '1'
    # per-epoch metrics go to logs/tuning/<identifier>/metrics.jsonl
    assert (tmp_path / 'logs' / 'tuning' / ident / 'metrics.jsonl').exists()


def test_select_on_valid_picks_the_best_block(tmp_path):
    _write_splits(tmp_path, seed=1)
    base = dict(name='nltcs', embedding=20, dim=6, batch=256, epoch=6,
                rate=0.01, ema=True, seed=0, note='seltest',
                data_dir=str(tmp_path))
    plain = run_experiment(TExp(**base), device='cpu')
    sel = run_experiment(TExp(**base, select_on_valid=2), device='cpu')
    assert 'best_epoch' not in plain and plain['platform'] == 'cpu'
    assert sel['best_epoch'] in (2, 4, 6)
    # the blocks follow plain fit's trajectory: the kept snapshot can only
    # match or beat the final epoch's valid PLL
    assert sel['pll_valid'] >= plain['pll_valid'] - 1e-9
    assert 'sov-2' in sel['identifier'] and 'sov' not in plain['identifier']


def test_posthoc_records_carry_the_jax_identifiers(tmp_path):
    _write_splits(tmp_path, seed=2)
    kw = dict(name='nltcs', embedding=10, dim=4, batch=256, epoch=1,
              rate=0.01, ema=True, seed=0, cpt_parents=1,
              cpt_parents_eval=(2, 0), cpt_parents_mix=True)
    res = run_experiment(TExp(**kw, data_dir=str(tmp_path)), device='cpu')
    jexp = JExp(**kw)
    assert res['identifier'] == dataclasses.replace(
        jexp, cpt_parents_eval=(), cpt_parents_mix=False).identifier
    ids = [r['identifier'] for r in res['posthoc']]
    assert ids == [dataclasses.replace(jexp, cpt_parents_eval=(m,),
                                       cpt_parents_mix=False).identifier
                   for m in (2, 0)] + [jexp.identifier]
    mix = res['posthoc'][-1]
    assert mix['mix_candidates'] == [0, 1, 2]
    assert sum(mix['mix_m_histogram'].values()) == 16
    # each variable picks its best valid contribution: the mix is at least
    # as good on valid as every candidate, the primary M included
    assert mix['pll_valid'] >= max(
        [r['pll_valid'] for r in res['posthoc'][:-1]]
        + [res['pll_valid']]) - 1e-9


SMALL = dict(name='nltcs', embedding=8, dim=4, batch=256, epoch=1, rate=0.01,
             ema=True, seed=0, units=(8, 6))


def _test_split(root):
    from pgmvae_tpu_torch.data.loader import load_split
    return load_split('nltcs', 'test', str(root))


def test_checkpoint_and_cmll_records(tmp_path, monkeypatch):
    import pgmvae_tpu_torch.gibbs as gibbs
    from pgmvae_tpu import checkpoint as jckpt
    from pgmvae_tpu_torch.serving import PgmModel
    cmll_fn, seen = gibbs.conditional_marginal_log_likelihood, []

    def short_cmll(*args, p1, num_smp, burn_in, **kw):
        # the driver's settings, run for 30 sweeps instead of 3000
        seen.append((p1, num_smp, burn_in))
        return cmll_fn(*args, p1=p1, num_smp=30, burn_in=5, **kw)
    monkeypatch.setattr(gibbs, 'conditional_marginal_log_likelihood',
                        short_cmll)
    _write_splits(tmp_path, seed=3)
    path = str(tmp_path / 'm.ckpt')
    exp = TExp(**SMALL, cmll=True, checkpoint=path, data_dir=str(tmp_path))
    res = run_experiment(exp, device='cpu')
    assert seen == [(1, 3000, 150)]
    cmll = res['cmll_test']
    assert np.isfinite(cmll) and cmll < 0 and cmll != 1
    assert res['cmll_wall'] >= 0
    # the file: the JAX package reads its config, CPT and extra
    cfg, _, dist, extra = jckpt.load(path)
    assert cfg.units == (8, 6) and cfg.num_codes == 8 and cfg.dim == 4
    assert extra == {'identifier': exp.identifier,
                     'pll': {k: res['pll_' + k]
                             for k in ('train', 'valid', 'test')}}
    assert dist.shape == (16, 8)
    # and serves the cell's test PLL
    scores = PgmModel.from_checkpoint(path, device='cpu').score(
        _test_split(tmp_path))
    np.testing.assert_allclose(scores.mean(), res['pll_test'], rtol=1e-5)


def test_resume_refuses_a_mismatch_with_the_jax_message(tmp_path):
    _write_splits(tmp_path, seed=4)
    path = str(tmp_path / 'm.ckpt')
    run_experiment(TExp(**SMALL, checkpoint=path, data_dir=str(tmp_path)),
                   device='cpu')
    bad = {**SMALL, 'decay': 0.5, 'units': (8, 5)}
    with pytest.raises(ValueError) as port:
        run_experiment(TExp(**bad, resume=path, data_dir=str(tmp_path)),
                       device='cpu')
    with pytest.raises(ValueError) as jax_side:
        jrun_experiment(JExp(**bad, resume=path, data_dir=str(tmp_path)))
    assert str(port.value) == str(jax_side.value)
    assert 'decay: checkpoint=0.99 cli=0.5' in str(port.value)
    assert 'units: checkpoint=(8, 6) cli=(8, 5)' in str(port.value)
    # an execution-only knob may differ; the resumed cell trains on
    res = run_experiment(TExp(**SMALL, precision='highest', resume=path,
                              data_dir=str(tmp_path)), device='cpu')
    assert res['pll_test'] < 0


def test_mix_cmll_wiring_and_the_servable_mix(tmp_path, monkeypatch):
    """--cmll + --cpt-parents-mix + --checkpoint: exactly two CMLL calls
    (the cell's table, then the composed mixture's, as
    tests/test_cpt_parents.py::test_mix_cmll_wiring holds the JAX driver
    to), and `<checkpoint>.mix` serves the mix record's test PLL, in the
    port and in the JAX package."""
    import pgmvae_tpu_torch.gibbs as gibbs
    from pgmvae_tpu.serving import PgmModel as JPgmModel
    from pgmvae_tpu_torch.serving import PgmModel
    calls = []

    def fake_cmll(params, codebook, cfg, dist, x, p1, num_smp, burn_in,
                  generator=None, verbose=False, parents=None):
        calls.append((np.asarray(dist).shape,
                      None if parents is None else np.asarray(parents).shape,
                      p1, num_smp, burn_in))
        return -1.234
    monkeypatch.setattr(gibbs, 'conditional_marginal_log_likelihood',
                        fake_cmll)
    _write_splits(tmp_path, seed=5)
    path = str(tmp_path / 'm.ckpt')
    res = run_experiment(TExp(**SMALL, cmll=True, cpt_parents_eval=(1, 2),
                              cpt_parents_mix=True, checkpoint=path,
                              data_dir=str(tmp_path)), device='cpu')
    assert len(calls) == 2 and res['cmll_test'] == -1.234
    mix = [r for r in res['posthoc'] if r['identifier'].endswith('_cpm')][0]
    assert mix['cmll_test'] == -1.234 and 'cmll_wall' in mix
    assert all(r['cmll_test'] == 1 for r in res['posthoc']
               if not r['identifier'].endswith('_cpm'))
    dist_shape, par_shape, p1, num_smp, burn_in = calls[-1]
    assert (p1, num_smp, burn_in) == (1, 3000, 150)
    m_max = mix['cmll_m_max']
    assert m_max == max(int(k) for k in mix['mix_m_histogram'])
    if m_max == 0:
        assert dist_shape == (16, 8) and par_shape is None
    else:
        assert dist_shape == (16, 8, 1 << m_max)
        assert par_shape == (16, m_max)
    assert calls[0][0] == (16, 8) and calls[0][1] is None

    assert mix['checkpoint'] == path + '.mix'
    y_test = _test_split(tmp_path)
    scores = PgmModel.from_checkpoint(path + '.mix', device='cpu').score(
        y_test)
    np.testing.assert_allclose(scores.mean(), mix['pll_test'], rtol=1e-5)
    np.testing.assert_allclose(
        scores, JPgmModel.from_checkpoint(path + '.mix').score(y_test),
        rtol=1e-5)
    # the base checkpoint still serves the primary (M=0) model
    base = PgmModel.from_checkpoint(path, device='cpu').score(y_test)
    np.testing.assert_allclose(base.mean(), res['pll_test'], rtol=1e-5)


@pytest.mark.parametrize('fields,left', [
    (dict(resume='m.ckpt', checkpoint='m.ckpt', cmll=True,
          adam_impl='fused_bf16'), []),
    (dict(mesh_model=2), []), (dict(mesh_data=2), []),
    (dict(compute_dtype='bf16', packed_seeds=3), []),    # ported since
    (dict(mesh_data=2, compute_dtype='bf16', cmll=True), [])])
def test_unported_names_only_a_mesh_and_bf16_compute(fields, left):
    """Every feature is ported, the device mesh included: nothing is
    left."""
    got = unported(TExp(name='nltcs', embedding=5, dim=3, **fields))
    assert [m.split('ROADMAP.md ')[1].split(',')[0] for m in got] == left


def test_a_mesh_cell_past_its_timeout_fails(tmp_path):
    """A spawned mesh world that runs past `mesh_timeout` is terminated and
    raises, rather than keep the caller waiting."""
    _write_splits(tmp_path, rows=(256, 64, 64))
    exp = TExp(name='nltcs', embedding=8, dim=4, batch=64, epoch=50,
               rate=0.01, ema=True, data_dir=str(tmp_path), mesh_data=2)
    with pytest.raises(TimeoutError):
        run_experiment(exp, device='cpu', mesh_timeout=1.0)


@pytest.mark.parametrize('mesh', [dict(mesh_data=2), dict(mesh_model=3)],
                         ids=['data2', 'model3'])
def test_mesh_cell_end_to_end_with_checkpoint_and_resume(tmp_path, mesh):
    """A mesh cell through `run_experiment` (its ranks spawned, gloo on the
    CPU) with --checkpoint and post-hoc joint-CPT records with a mixture:
    the PLLs of the single-device run; on model=3 the variable axis is
    padded 16 -> 18 and invisible. Rank 0's checkpoint is the whole model
    (a single-device template loads it), and a mesh run resumes from it.
    (The CMLL's 3000 sweeps are too slow for the CPU suite; rank 0's
    share of it is `MeshContext.on_rank0`, held in test_torch_mesh.py.)"""
    from pgmvae_tpu_torch import checkpoint as ckpt
    from pgmvae_tpu_torch.driver import _model_config
    from pgmvae_tpu_torch.train import Trainer
    _write_splits(tmp_path, rows=(256, 64, 64))
    base = dict(name='nltcs', embedding=8, dim=4, batch=64, epoch=2,
                rate=0.01, ema=True, seed=3, data_dir=str(tmp_path),
                cpt_parents_eval=(1,), cpt_parents_mix=True)
    path = str(tmp_path / 'm.ckpt')
    got = run_experiment(TExp(**base, **mesh, checkpoint=path),
                         device='cpu')
    one = run_experiment(TExp(**base), device='cpu')
    assert got['identifier'] == one['identifier']
    for key in ('pll_train', 'pll_valid', 'pll_test'):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5)
    assert [p['identifier'] for p in got['posthoc']] == [
        p['identifier'] for p in one['posthoc']]
    for p, q in zip(got['posthoc'], one['posthoc']):
        np.testing.assert_allclose(p['pll_test'], q['pll_test'], rtol=1e-5)
    ranks = mesh.get('mesh_data', 1) * mesh.get('mesh_model', 1)
    assert got['mesh']['devices'] == ['cpu'] * ranks
    assert got['mesh']['backend'] == 'gloo'
    cfg = _model_config(TExp(**base, **mesh))[0]
    assert cfg.n_var == (18 if mesh.get('mesh_model') == 3 else 16)
    saved, state, dist, extra = ckpt.load(path, Trainer(
        cfg, 0.01, 64, 256, device='cpu').init_state(0))
    assert saved == cfg and state.params['enc'][0][0].shape[0] == cfg.n_var
    assert os.path.exists(path + '.mix')
    res = run_experiment(TExp(**{**base, 'epoch': 1}, **mesh, resume=path),
                         device='cpu')
    assert np.isfinite(res['pll_test'])
