"""The port's command line on a train split past the Trainer's
`stream_bytes` (lowered here so that a small split streams): the native
parser reads kdd-named CSVs from --data-dir, `Trainer.fit` streams the
train split from the host in chunks, stage 2 counts it in pieces, and the
result line, PLLs and metrics log are bit-equal to the same run in core,
under the JAX package's identifier for the same flags."""

import json

import numpy as np
import pytest

from pgmvae_tpu.utils.logging import run_identifier as jax_identifier
from pgmvae_tpu_torch import run
from pgmvae_tpu_torch.data import native
from pgmvae_tpu_torch.train import Trainer

ROWS = {'train': 1500, 'valid': 300, 'test': 200}
BS = 64                            # 24 steps an epoch, the last one ragged
FLAGS = ['-n', 'kdd', '-k', '16', '-d', '4', '-b', str(BS), '-e', '2',
         '-r', '0.01', '-c', '0.25', '-m', '-s', '1', '--units', '12,8',
         '--adam-impl', 'pallas', '--device', '-1']


def _write_splits(root):
    """kdd-shaped 0/1 splits (64 columns) in the TRW files' layout."""
    rng = np.random.default_rng(0)
    rate = rng.random(64) * 0.3
    for split, rows in ROWS.items():
        y = (rng.random((rows, 64)) < rate).astype(np.uint8)
        text = '\n'.join(','.join(map(str, r)) for r in y) + '\n'
        (root / f'kdd.{split}.data').write_text(text)


def _run(tmp_path, monkeypatch, name, stream_bytes, chunk_bytes):
    """run.main in tmp_path/name on the shared splits, with the Trainer's
    stream thresholds set; (exit code, result lines, metrics log, streamed
    epochs, native parses)."""
    init, streamed_fn = Trainer.__init__, Trainer._run_epoch_streamed
    streamed = []

    def patched_init(self, *a, **k):
        init(self, *a, **k)
        self.stream_bytes, self.stream_chunk_bytes = stream_bytes, chunk_bytes

    def spy(self, *a):
        streamed.append(self._chunk_steps(a[1]))
        return streamed_fn(self, *a)
    monkeypatch.setattr(Trainer, '__init__', patched_init)
    monkeypatch.setattr(Trainer, '_run_epoch_streamed', spy)
    out = tmp_path / name
    out.mkdir()
    monkeypatch.chdir(out)
    parses = native.PARSES
    rc = run.main(FLAGS + ['--data-dir', str(tmp_path / 'data')])
    parsed = native.PARSES - parses
    lines = (out / 'result.txt').read_text().splitlines()
    ident = lines[0].split(' ', 1)[0]
    with open(out / 'logs' / 'tuning' / ident / 'metrics.jsonl') as f:
        metrics = [json.loads(line) for line in f]
    monkeypatch.undo()
    return rc, lines, metrics, streamed, parsed


@pytest.mark.parametrize('chunk_steps', [1, 5, 64])
def test_cli_streamed_equals_in_core(tmp_path, monkeypatch, chunk_steps):
    (tmp_path / 'data').mkdir()
    _write_splits(tmp_path / 'data')
    n_bytes = ROWS['train'] * 64 * 4
    rc, core, core_log, core_streamed, _ = _run(
        tmp_path, monkeypatch, 'core', 4 << 30, 64 << 20)
    rc_s, lines, log, streamed, parsed = _run(
        tmp_path, monkeypatch, 'streamed', n_bytes - 1,
        chunk_steps * BS * 64 * 4)
    assert rc == rc_s == 0
    assert core_streamed == [] and streamed == [min(chunk_steps, 24)] * 2
    if native.available():
        assert parsed == 3
    assert len(lines) == 1 and lines == core
    ident, rest = lines[0].split(' ', 1)
    assert ident == jax_identifier('kdd', 16, 4, BS, 2, 0.01, 0.25, True,
                                   0.99, 1, units=(12, 8),
                                   adam_impl='pallas')
    plls = dict(kv.split(':') for kv in rest.split())
    assert all(np.isfinite(float(plls[k])) and float(plls[k]) < 0
               for k in ('pll-train', 'pll-valid', 'pll-test'))

    def numbers(records):
        return [{k: v for k, v in r.items() if 'wall' not in k
                 and k != 'samples_per_sec'} for r in records]
    assert numbers(log) == numbers(core_log)
    assert [r['epoch'] for r in log[:-1]] == [0, 1]
