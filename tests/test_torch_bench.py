"""The port's measurement entry points against the JAX package's:
`pgmvae_tpu_torch.bench` against the root `bench.py` (FLOP model, cell
table, training, the line it prints), `bench_packed` and `bench_cmll`
against `scripts/bench_packed.py` and `scripts/bench_cmll.py`, and the
synthetic data module against `scripts/synth_kdd.py`. Everything runs on
the CPU (`device='cpu'` or `--device -1`)."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.registry import REGISTRY as JREGISTRY
from pgmvae_tpu.registry import default_units as jdefault_units
from pgmvae_tpu_torch import bench, bench_cmll, bench_packed
from pgmvae_tpu_torch.data import synthetic
from pgmvae_tpu_torch.data.loader import load_split
from pgmvae_tpu_torch.gibbs import conditional_marginal_log_likelihood
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.train import Trainer, _map_state, copy_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the root bench.py's line, and of scripts/bench_packed.py's
JAX_LINE_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'platform',
                 'nltcs_dispatch_bound_sps'}
JAX_CELL_KEYS = {'samples_per_sec', 'gflop_per_sample', 'mfu_pct'}
JAX_PACKED_KEYS = {'config', 'seeds', 'serial_wall', 'packed_wall',
                   'serial_agg_sps', 'packed_agg_sps', 'speedup', 'device'}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def jbench():
    """The root bench.py (it imports JAX only inside its functions)."""
    return _load('jax_bench_root', 'bench.py')


def _leaves(state):
    out = []
    _map_state(out.append, state)
    return out


def _write_nltcs_like(root, rows=(64, 16, 24)):
    rng = np.random.default_rng(0)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < 0.4).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{')]


# ------------------------------------------------------------ bench.py --
FLOP_CONFIGS = {
    'nltcs': dict(n_var=16, units=(15, 14, 13, 12), dim=10, num_codes=50),
    'bbc': dict(n_var=1058, units=JREGISTRY['bbc'].encoder_units(20),
                dim=20, num_codes=50, fan_mode='per_network'),
    'ad': dict(n_var=1556, units=jdefault_units(1556, 30), dim=30,
               num_codes=20),
    'kdd': dict(n_var=64, units=(50, 40, 30, 20), dim=10, num_codes=4096),
    'naive': dict(n_var=20, units=(9, 7), dim=6, num_codes=3,
                  quantizer='naive'),
}


@pytest.mark.parametrize('name', sorted(FLOP_CONFIGS))
def test_train_flops_per_sample_equals_bench_py(jbench, name):
    kw = FLOP_CONFIGS[name]
    got = bench.train_flops_per_sample(tv.VqVaeConfig(**kw))
    assert got == jbench.train_flops_per_sample(JCfg(**kw)) > 0


def test_cell_table_equals_bench_py(jbench, monkeypatch, tmp_path, capsys):
    """bench.py's main run with its trainer, stage 2, loader, TF2 probe and
    chip probe stubbed and bench_model recording its arguments: the port's
    headline config and its CELLS match what it benches, key by key."""
    import pgmvae_tpu.data
    import pgmvae_tpu.stage2
    import pgmvae_tpu.train
    import pgmvae_tpu.utils.cache

    calls, trainers = {}, []
    marker = {}

    def load(name, split):
        return marker.setdefault((name, split), np.zeros((3, JREGISTRY[
            name].n_var), np.float32))

    class FakeTrainer:
        def __init__(self, cfg, lr, batch, n, **kw):
            trainers.append((cfg, lr, batch, kw))

        def init_state(self, key):
            return types.SimpleNamespace(params=None)

        def run_epochs(self, state, data, key, start, epochs):
            trainers.append(('epochs', start, epochs))
            return state, None

        def codebook(self, state):
            return None

    class FakeStage2:
        def __init__(self, cfg):
            pass

        def cpt(self, *a):
            return None

        def pseudo_log_likelihood(self, *a):
            return 0.0

    def record(label, cfg, data, batch, lr, epochs, adam_impl='optax'):
        calls[label] = (cfg, data, batch, lr, epochs, adam_impl)
        return {'label': label}
    monkeypatch.setattr(jbench, 'probe_chip', lambda: True)
    monkeypatch.setattr(jbench, 'measure_tf2_baseline',
                        lambda: (jbench.TF2_MEASURED_FALLBACK, 'recorded'))
    monkeypatch.setattr(jbench, 'bench_model', record)
    monkeypatch.delenv('PGMVAE_BENCH_CPU', raising=False)
    monkeypatch.setattr(pgmvae_tpu.utils.cache, 'enable_compilation_cache',
                        lambda: None)
    monkeypatch.setattr(pgmvae_tpu.data, 'load_split', load)
    monkeypatch.setattr(pgmvae_tpu.train, 'Trainer', FakeTrainer)
    monkeypatch.setattr(pgmvae_tpu.stage2, 'Stage2', FakeStage2)
    monkeypatch.chdir(tmp_path)             # its logs/bench_tpu_last.json
    assert jbench.main() == 0
    line = _json_lines(capsys.readouterr().out)[-1]

    # the headline: nltcs, lr 0.01, bs 128, 64 warm then 64 timed epochs
    cfg, lr, batch, _ = trainers[0]
    assert cfg._asdict() == bench.NLTCS_CFG._asdict()
    assert (lr, batch) == (0.01, 128)
    assert trainers[1:] == [('epochs', 0, bench.HEADLINE_EPOCHS)] * 2

    cells = {k: v for k, v in line.items() if isinstance(v, dict)}
    assert list(cells) == [c.key for c in bench.CELLS]
    for cell in bench.CELLS:
        got = cells[cell.key]
        assert got['label'] == cell.label
        jcfg, data, batch, lr, epochs, adam_impl = calls[cell.label]
        assert jcfg._asdict() == cell.cfg._asdict(), cell.key
        assert (batch, lr, epochs, adam_impl) == (
            cell.batch, cell.lr, cell.epochs, cell.adam_impl), cell.key
        assert {k: v for k, v in got.items() if k != 'label'} == (
            cell.record or {}), cell.key
        if cell.data == bench.AD_UNIFORM:
            y, label = bench.cell_data(cell)
            np.testing.assert_array_equal(y, data)
            assert label.startswith('uniform')
        else:
            assert data is marker[(cell.data, 'train')], cell.key


def test_bench_model_trains_for_real(monkeypatch):
    """bench_model's run from init_state(1): a warm run_epochs with seed 0,
    the timed one with seed 1 from the warm state; its final state is
    bit-equal to that sequence run outside the bench."""
    cfg = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7,
                         decay=0.9, dead_code_threshold=0.5)
    y = np.random.default_rng(2).integers(0, 2, (37, 6)).astype(np.float32)
    seen = []
    run_epochs = Trainer.run_epochs

    def spy(self, state, data, seed, start, epochs):
        out = run_epochs(self, state, data, seed, start, epochs)
        seen.append((seed, start, epochs, out[0]))
        return out
    monkeypatch.setattr(Trainer, 'run_epochs', spy)
    res = bench.bench_model('tiny', cfg, y, 8, 0.01, 2, device='cpu')
    assert JAX_CELL_KEYS <= set(res)
    assert res['samples_per_sec'] > 0 and res['mfu_pct'] >= 0
    assert res['peak_tflops'] == 67.0
    assert res['gflop_per_sample'] == round(
        bench.train_flops_per_sample(cfg) / 1e9, 3)
    assert [s[:3] for s in seen] == [(0, 0, 2), (1, 0, 2)]
    final = seen[-1][3]
    monkeypatch.setattr(Trainer, 'run_epochs', run_epochs)
    tr = Trainer(cfg, 0.01, 8, len(y), device='cpu')
    init = tr.init_state(1)
    ref = copy_state(init)
    data = torch.as_tensor(y)
    ref, _ = tr.run_epochs(ref, data, 0, 0, 2)
    ref, _ = tr.run_epochs(ref, data, 1, 0, 2)
    for a, b in zip(_leaves(final), _leaves(ref), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(final.step) == 2 * 2 * 5
    assert not torch.equal(final.params['enc'][0][0],
                           init.params['enc'][0][0])


def test_bf16_cells_divide_by_the_bf16_peak():
    for cell in bench.CELLS:
        want = 989.0 if cell.cfg.compute_dtype == 'bf16' else 67.0
        assert bench.peak_flops(cell.cfg) / 1e12 == want, cell.key
    assert {c.key for c in bench.CELLS
            if c.cfg.compute_dtype == 'bf16'} == {
        'bbc_bs250_bf16', 'bbc_bs500_bf16', 'bbc_bs1000_rank1_bf16'}


@pytest.mark.parametrize('module', [bench, bench_packed, bench_cmll],
                         ids=lambda m: m.__name__.rsplit('.', 1)[-1])
def test_main_without_cuda_exits_nonzero_and_prints_no_result(
        module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = module.main([])
    out, err = capsys.readouterr()
    assert rc != 0
    assert not _json_lines(out) and out == ''
    assert '--device -1' in err


def test_main_on_cpu_prints_the_line_and_records_a_failed_cell(
        monkeypatch, tmp_path, capsys):
    """--device -1 with tiny TRW CSVs and two tiny cells, the second of
    which raises: one line with bench.py's keys plus data/device/
    peak_tflops, the failure as <key>_error, the other cell measured, and
    exit code 1."""
    _write_nltcs_like(str(tmp_path))
    cfg = tv.VqVaeConfig(n_var=16, units=(6, 5), dim=3, num_codes=4)
    monkeypatch.setattr(bench, 'CELLS', (
        bench.Cell('tiny_ok', 'tiny ok', cfg, 'nltcs', 16, 0.01, 2),
        bench.Cell('tiny_bad', 'tiny bad', cfg, 'nltcs', 16, 0.01, 2,
                   'sgd')))
    rc = bench.main(['--device', '-1', '--data-dir', str(tmp_path)])
    out, err = capsys.readouterr()
    lines = _json_lines(out)
    assert rc == 1 and len(lines) == 1, out
    line = lines[0]
    assert JAX_LINE_KEYS | {'data', 'device', 'peak_tflops'} <= set(line)
    assert line['platform'] == 'cpu' and line['device'] == 'cpu'
    assert line['data'] == f'trw:{tmp_path}'
    assert line['unit'] == 'samples/sec/chip'
    assert line['value'] == line['nltcs_dispatch_bound_sps'] > 0
    assert line['vs_baseline'] == round(
        line['value'] / bench.TF2_MEASURED_FALLBACK, 2)
    assert line['peak_tflops'] == 67.0
    head = line['headline']
    assert head['epochs'] == bench.HEADLINE_EPOCHS
    assert np.isfinite(head['pll_test']) and head['pll_test'] < 0
    ok = line['tiny_ok']
    assert JAX_CELL_KEYS | {'peak_tflops', 'data'} <= set(ok)
    assert ok['samples_per_sec'] > 0 and ok['data'] == f'trw:{tmp_path}'
    assert 'tiny_bad' not in line
    assert line['tiny_bad_error'].startswith('ValueError: unknown adam_impl')
    assert 'tiny bad failed' in err


def test_cells_without_trw_data_train_on_labelled_synthetic_splits(
        tmp_path):
    """A data directory without the dataset's CSVs: the registry-shaped
    shared-factor splits, labelled; the ad cell: bench.py's uniform bits."""
    bbc = next(c for c in bench.CELLS if c.data == 'bbc')
    y, label = bench.cell_data(bbc, str(tmp_path))
    assert label == 'synthetic shared-factor, seed 0'
    assert y.shape == (1670, 1058) and y.dtype == np.float32
    np.testing.assert_array_equal(
        y, synthetic.shared_factor_splits('bbc', 0)['train'])
    ad = next(c for c in bench.CELLS if c.data == bench.AD_UNIFORM)
    y, _ = bench.cell_data(ad, str(tmp_path))
    ref = np.random.default_rng(0).integers(0, 2, size=(2461, 1556))
    np.testing.assert_array_equal(y, ref.astype(np.float32))


# --------------------------------------------------------- synthetic --
def test_synth_rows_equals_the_script():
    script = _load('synth_kdd_script', 'scripts/synth_kdd.py')
    for n_rows, n_var, seed in ((1000, 64, 3), (17, 5, 0)):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        got = synthetic.synth_rows(n_rows, n_var, a)
        ref = script.synth_rows(n_rows, n_var, b)
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        assert a.bit_generator.state == b.bit_generator.state


def _kdd_like_splits_before():
    """chip_smoke.py's `_kdd_like_splits` as it stood before the synthetic
    module took its body (numpy seed 0, one loading for all splits)."""
    n_var, sizes = 64, (180092, 19907, 34955)
    rng = np.random.default_rng(0)
    loading = rng.random((16, n_var)) < 0.12

    def rows(n):
        z = rng.random((n, 16)) < 0.2
        y = (z.astype(np.uint8) @ loading.astype(np.uint8)) > 0
        noise = rng.random((n, n_var)) < 0.02
        return (y ^ noise).astype(np.float32)
    return {split: rows(n) for split, n in zip(('train', 'valid', 'test'),
                                               sizes)}


def test_shared_factor_splits_equal_the_smokes_kdd_splits():
    smoke = _load('chip_smoke_for_test', 'chip_smoke.py')
    got = synthetic.shared_factor_splits('kdd', 0)
    for ref in (_kdd_like_splits_before(), smoke._kdd_like_splits()):
        assert list(ref) == list(got)
        for split in ref:
            assert got[split].dtype == ref[split].dtype == np.float32
            np.testing.assert_array_equal(got[split], ref[split])


def test_load_or_synthesize_prefers_the_csvs(tmp_path):
    _write_nltcs_like(str(tmp_path))
    splits, label = synthetic.load_or_synthesize('nltcs', str(tmp_path))
    assert label == f'trw:{tmp_path}'
    for split in ('train', 'valid', 'test'):
        np.testing.assert_array_equal(
            splits[split], load_split('nltcs', split, str(tmp_path)))
    splits, label = synthetic.load_or_synthesize('nltcs',
                                                 str(tmp_path / 'none'),
                                                 seed=4)
    assert label == 'synthetic shared-factor, seed 4'
    assert [s.shape for s in splits.values()] == [(16181, 16), (2157, 16),
                                                  (3236, 16)]


# ------------------------------------------------------- bench_packed --
def test_bench_packed_record_and_seed_identity(monkeypatch, tmp_path,
                                               capsys):
    """The record has scripts/bench_packed.py's keys and lands in --out;
    the timed packed run's seeds equal their timed serial runs at
    tests/test_torch_packed.py's tolerance (1e-6 of each leaf's largest
    magnitude), each serial seed starting from a fresh init."""
    _write_nltcs_like(str(tmp_path), rows=(40, 8, 8))
    serial, packed = [], []
    run_epochs, run_packed = Trainer.run_epochs, Trainer.run_epochs_packed

    def spy(self, *a):
        out = run_epochs(self, *a)
        serial.append(copy_state(out[0]))
        return out

    def spy_packed(self, *a):
        out = run_packed(self, *a)
        packed.append(copy_state(out[0]))
        return out
    monkeypatch.setattr(Trainer, 'run_epochs', spy)
    monkeypatch.setattr(Trainer, 'run_epochs_packed', spy_packed)
    out_file = tmp_path / 'logs' / 'bp.jsonl'
    rc = bench_packed.main(['-n', 'nltcs', '-k', '5', '-d', '3', '-b', '16',
                            '-e', '2', '-s', '3', '--device', '-1',
                            '--data-dir', str(tmp_path), '--out',
                            str(out_file)])
    assert rc == 0
    rec = _json_lines(capsys.readouterr().out)[-1]
    assert JAX_PACKED_KEYS <= set(rec)
    assert rec['config'] == 'nltcs K=5 D=3 bs=16 e=2 ema'
    assert rec['seeds'] == 3 and rec['speedup'] > 0
    assert rec['data'] == f'trw:{tmp_path}' and rec['device'] == 'cpu'
    assert json.loads(out_file.read_text().splitlines()[-1]) == rec
    assert len(serial) == 1 + 3 and len(packed) == 2
    tr = Trainer(tv.VqVaeConfig(n_var=16, units=(15, 14, 13, 12), dim=3,
                                num_codes=5), 0.001, 16, 40, device='cpu')
    for s in range(3):
        got = Trainer.unpack_seed(packed[-1], s)
        ref = serial[1 + s]
        for a, b in zip(_leaves(got), _leaves(ref), strict=True):
            gap = float((a.double() - b.double()).abs().max())
            assert gap <= 1e-6 * float(b.double().abs().max()), (s, gap)
        # seed s+1's serial run started from a fresh init_state(s+1)
        fresh, _ = tr.fit(tr.init_state(s + 1),
                          load_split('nltcs', 'train', str(tmp_path)), 2,
                          seed=s + 1)
        for a, b in zip(_leaves(fresh), _leaves(ref), strict=True):
            assert torch.equal(a, b)


def test_copy_state_into_keeps_the_destinations_tensors():
    from pgmvae_tpu_torch.train import copy_state_into
    tr = Trainer(tv.VqVaeConfig(n_var=6, units=(5,), dim=3, num_codes=4),
                 0.01, 8, 20, device='cpu')
    dst, src = tr.init_state(1), tr.init_state(2)
    ptrs = [t.data_ptr() for t in _leaves(dst)]
    out = copy_state_into(dst, src)
    assert [t.data_ptr() for t in _leaves(out)] == ptrs
    for a, b in zip(_leaves(out), _leaves(src), strict=True):
        assert torch.equal(a, b)


# --------------------------------------------------------- bench_cmll --
def test_bench_cmll_returns_the_public_cmll(capsys):
    """Both timed calls give what conditional_marginal_log_likelihood gives
    on the bench's trained model with generators seeded 1 and 2."""
    argv = ['--vars', '24', '--samples', '48', '--k', '5', '--dim', '4',
            '--num-smp', '12', '--burn-in', '2', '--device', '-1']
    assert bench_cmll.main(argv) == 0
    out = capsys.readouterr().out
    rec = _json_lines(out)[-1]
    assert out.splitlines()[0].startswith('cmll=')
    assert rec['p1'] == 2 and rec['blocks'] == 12 and rec['steps'] == 24
    assert rec['platform'] == 'cpu'
    cfg, st, tr, data, dist = bench_cmll.model(
        bench_cmll.build_parser().parse_args(argv), torch.device('cpu'))
    for seed, key in ((1, 'cmll_first'), (2, 'cmll')):
        ref = conditional_marginal_log_likelihood(
            st.params, tr.codebook(st), cfg, dist, data, p1=2, num_smp=12,
            burn_in=2, generator=torch.Generator().manual_seed(seed))
        assert rec[key] == ref and np.isfinite(ref) and ref < 0
    assert rec['cmll'] != rec['cmll_first']
