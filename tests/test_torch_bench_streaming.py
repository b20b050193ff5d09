"""The out-of-core twin (`pgmvae_tpu_torch.bench_streaming`) against the
JAX package's `scripts/bench_streaming.py`: the same data bytes, flags and
model, and on the CPU a run of its `main` at a small size whose epoch is
streamed from the host."""

import json
import os
import re

import numpy as np
import pytest
import torch

from pgmvae_tpu.registry import default_units as jax_default_units
from pgmvae_tpu_torch import bench_streaming
from pgmvae_tpu_torch import train as ttrain

CoreTrainer = ttrain.Trainer
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, 'scripts', 'bench_streaming.py')
SMALL = ['--vars', '8', '--gib', '2e-5', '--batch', '32', '--k', '8',
         '--dim', '3', '--device', '-1']
JAX_KEYS = ('rows', 'vars', 'gib', 'batch', 'stream_epoch_wall',
            'stream_sps', 'incore_sps_subset', 'stream_vs_incore', 'loss',
            'device')
PORT_KEYS = ('platform', 'chunk_steps', 'capture_ms', 'incore_capture_ms',
             'launches', 'peak_gb_streamed', 'peak_gb_incore_subset',
             'generate_s')


def _jax_recipe(gib, n_vars):
    """scripts/bench_streaming.py:46-54, as written there."""
    rows = int(gib * (1 << 30) / (n_vars * 4))
    rng = np.random.default_rng(0)
    data = np.empty((rows, n_vars), np.float32)
    step = 1 << 20
    for s in range(0, rows, step):      # chunked fill keeps peak RAM flat
        e = min(s + step, rows)
        data[s:e] = rng.integers(0, 2, size=(e - s, n_vars))
    return data


@pytest.mark.parametrize('gib,n_vars', [(0.001, 64), (0.011, 2)])
def test_data_is_byte_equal_to_the_jax_recipe(gib, n_vars):
    """At 64 variables, and at 2 where the rows pass one fill of 1 << 20."""
    rows = bench_streaming.dataset_rows(gib, n_vars)
    got = bench_streaming.make_data(rows, n_vars)
    want = _jax_recipe(gib, n_vars)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if n_vars == 2:
        assert rows > bench_streaming.FILL_ROWS


def test_flags_and_model_are_the_jax_scripts():
    """The JAX script's flags with its defaults (its `--out` aside), and at
    them 18,874,368 x 64 rows (4.5 GiB) for the units (32, 21, 12, 10)."""
    with open(JAX_SCRIPT) as f:
        src = f.read()
    jax_defaults = dict(re.findall(
        r"add_argument\('--(\w+)', type=\w+, default=([\d.]+)", src))
    args = bench_streaming.build_parser().parse_args([])
    assert set(jax_defaults) == {'vars', 'gib', 'batch', 'k', 'dim'}
    for name, value in jax_defaults.items():
        assert getattr(args, name) == type(getattr(args, name))(value), name
    assert args.device == 0
    assert args.out == 'logs/bench_streaming_torch.jsonl'
    rows = bench_streaming.dataset_rows(args.gib, args.vars)
    assert rows == 18_874_368 and rows * args.vars * 4 == int(4.5 * 2**30)
    cfg = bench_streaming.model_config(args)
    assert cfg.units == (32, 21, 12, 10) == jax_default_units(64, 10)
    assert (cfg.n_var, cfg.dim, cfg.num_codes, cfg.quantizer) == (
        64, 10, 64, 'ema')


def _trainer(stream_bytes, chunk_steps, streamed=None, made=None):
    """The port's Trainer with `stream_bytes` and chunks of `chunk_steps`
    steps at SMALL's batch; with `streamed`, each streamed epoch records
    whether its data is the generated array (`made[0]`) itself."""
    class Patched(CoreTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, stream_bytes=stream_bytes,
                             stream_chunk_bytes=chunk_steps * 32 * 8 * 4,
                             **k)

        def _run_epoch_streamed(self, state, data, generator):
            if streamed is not None:
                streamed.append(np.shares_memory(data, made[0]))
            return super()._run_epoch_streamed(state, data, generator)
    return Patched


def _leaves(state):
    out = []
    ttrain._map_state(out.append, state)
    return out


def test_main_streams_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`main --device -1` with the Trainer's stream_bytes below the data's
    bytes: the fit's epoch goes through `_run_epoch_streamed`, in chunks,
    on the generated array itself (no copy), and the record with the JAX
    keys and the port's is printed and appended to --out."""
    made, streamed = [], []
    make = bench_streaming.make_data
    monkeypatch.setattr(bench_streaming, 'make_data',
                        lambda *a: made.append(make(*a)) or made[-1])
    monkeypatch.setattr(ttrain, 'Trainer', _trainer(1024, 5, streamed, made))
    out = tmp_path / 'logs' / 'bs.jsonl'
    assert bench_streaming.main(SMALL + ['--out', str(out)]) == 0
    assert streamed == [True]
    line = json.loads(capsys.readouterr().out.strip())
    assert json.loads(out.read_text()) == line
    assert set(JAX_KEYS + PORT_KEYS) <= set(line)
    assert line['rows'] == 671 and line['vars'] == 8 and line['batch'] == 32
    assert line['chunk_steps'] == 5
    assert line['device'] == 'cpu' and line['platform'] == 'cpu'
    assert np.isfinite(line['loss']) and line['stream_sps'] > 0
    assert line['peak_gb_streamed'] is None and line['capture_ms'] is None
    assert line['launches'] == dict.fromkeys(
        ('vq_argmin', 'vq_argmin_bf16', 'adam', 'adam_bf16', 'ema', 'recon',
         'first_layer'), 0)


def test_streamed_run_is_the_in_core_fit(monkeypatch):
    """The state `measure` returns is bit-equal to an in-core fit of the
    same data from the same init and seed."""
    monkeypatch.setattr(ttrain, 'Trainer', _trainer(0, 3))
    args = bench_streaming.build_parser().parse_args(SMALL)
    run = bench_streaming.measure(args, torch.device('cpu'))
    core = CoreTrainer(bench_streaming.model_config(args), 0.001, 32,
                       len(run.data), device='cpu')
    ref, _ = core.fit(core.init_state(0), run.data, 1, seed=1)
    for a, b in zip(_leaves(run.state), _leaves(ref), strict=True):
        assert torch.equal(a, b)


def test_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert bench_streaming.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == '' and '--device -1' in captured.err
