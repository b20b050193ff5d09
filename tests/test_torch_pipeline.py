"""The port's sweep runner (`pgmvae_tpu_torch.run_pipeline`) against the
JAX package's `run_pipeline.py`: the same grouping of packed seeds, resume
classification and joblog reading on the same grids and joblogs, and on
synthetic nltcs-shaped splits the same joblog and `result.txt`
identifiers, a resume that runs nothing, --retry-failed, isolated cells in
`python -m pgmvae_tpu_torch._cell_runner` processes, and mesh cells that
run in worlds of their own."""

import dataclasses
import json
import os

import numpy as np
import pytest

import run_pipeline as jpipe
from pgmvae_tpu.driver import ExperimentConfig as JExp
from pgmvae_tpu_torch import run_pipeline as tpipe
from pgmvae_tpu_torch.driver import ExperimentConfig as TExp

BASE = dict(name='nltcs', embedding=8, dim=4, batch=128, epoch=1,
            rate=0.01, ema=True)


def _grid(cls, **over):
    return [cls(**{**BASE, **over, 'embedding': k}, seed=s)
            for k in (8, 16) for s in (0, 1, 2)]


@pytest.mark.parametrize('pack', [1, 2, 4])
def test_group_packed_equals_jax(pack):
    mine = tpipe.group_packed(_grid(TExp), pack)
    ref = jpipe.group_packed(_grid(JExp), pack)
    assert [[c.identifier for c in g] for g in mine] == \
        [[c.identifier for c in g] for g in ref]


def _status(records):
    return {r['identifier']: r for r in records}


def _cases():
    """(cell fields, group width, joblog records, want_cmll)."""
    def ident(**kw):
        return TExp(**{**BASE, 'seed': 1, **kw}).identifier
    cpe = dict(cpt_parents_eval=(1,))
    return [
        ({}, 2, [], False),
        ({}, 2, [{'identifier': ident(packed_seeds=2), 'ok': True}], False),
        ({}, 2, [{'identifier': ident(), 'ok': True}], False),
        ({}, 3, [{'identifier': ident(packed_seeds=2), 'ok': True}], False),
        ({}, 2, [{'identifier': ident(packed_seeds=2), 'ok': False}], False),
        ({}, 2, [{'identifier': ident(packed_seeds=2), 'ok': False},
                 {'identifier': ident(), 'ok': True}], False),
        ({}, 1, [{'identifier': ident(), 'ok': True, 'cmll_test': 1}], True),
        ({}, 1, [{'identifier': ident(), 'ok': True, 'cmll_test': -5.0}],
         True),
        (cpe, 1, [{'identifier': ident(), 'ok': True}], False),
        (cpe, 1, [{'identifier': ident(), 'ok': True},
                  {'identifier': ident(**cpe), 'ok': True}], False),
        (dict(cpe, cpt_parents_mix=True), 1,
         [{'identifier': ident(), 'ok': True},
          {'identifier': ident(**cpe), 'ok': True}], False),
    ]


@pytest.mark.parametrize('case', range(len(_cases())))
def test_classify_cell_equals_jax(case):
    fields, width, records, want_cmll = _cases()[case]
    status = _status(records)
    mine = tpipe.classify_cell(TExp(**BASE, seed=1, **fields), width,
                               status, want_cmll)
    ref = jpipe.classify_cell(JExp(**BASE, seed=1, **fields), width, status,
                              want_cmll)
    assert mine == ref


def test_load_joblog_equals_jax(tmp_path):
    path = tmp_path / 'j.jsonl'
    lines = [json.dumps({'identifier': 'a', 'ok': False}),
             'not json', json.dumps({'no_identifier': 1}),
             json.dumps({'identifier': 'b', 'ok': True, 'pll_test': -5.0}),
             json.dumps({'identifier': 'a', 'ok': True}), '']
    path.write_text('\n'.join(lines))
    assert tpipe.load_joblog(str(path)) == jpipe.load_joblog(str(path))
    assert tpipe.load_joblog(str(path))['a']['ok'] is True
    assert tpipe.load_joblog(str(tmp_path / 'missing')) == {}


def _write_splits(root, rows=(600, 200, 200), seed=0):
    rng = np.random.default_rng(seed)
    rate = rng.random(16)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < rate).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


GRID = ['-n', 'nltcs', '-k', '8,16', '-d', '4', '-b', '128', '-e', '1',
        '-r', '0.01', '-m', '-s', '1,2', '--pack-seeds', '2']


def _run(module, root, tag, flags):
    return module.main(flags + ['--device', '-1', '--data-dir', str(root),
                                '--joblog', str(root / f'{tag}.jsonl'),
                                '--result-file', str(root / f'{tag}.txt')])


def _joblog(root, tag):
    with open(root / f'{tag}.jsonl') as f:
        return [json.loads(line) for line in f]


def _result_ids(root, tag):
    return [line.split(' ', 1)[0]
            for line in (root / f'{tag}.txt').read_text().splitlines()]


def test_main_writes_the_jax_runners_lines_and_resumes(tmp_path):
    _write_splits(tmp_path)
    assert _run(tpipe, tmp_path, 'port', GRID) == 0
    assert _run(jpipe, tmp_path, 'jax', GRID) == 0
    port, ref = _joblog(tmp_path, 'port'), _joblog(tmp_path, 'jax')
    assert [r['identifier'] for r in port] == [r['identifier'] for r in ref]
    assert all(r['identifier'].endswith('_pk-2') and r['ok'] for r in port)
    assert {k for r in port for k in r} == {k for r in ref for k in r}
    assert _result_ids(tmp_path, 'port') == _result_ids(tmp_path, 'jax')
    assert all(r['platform'] == 'cpu' and r['packed_seeds'] == 2
               for r in port)
    # the same command again: every cell is done, nothing runs
    assert _run(tpipe, tmp_path, 'port', GRID) == 0
    assert len(_joblog(tmp_path, 'port')) == 4
    assert len(_result_ids(tmp_path, 'port')) == 4


def test_retry_failed(tmp_path):
    _write_splits(tmp_path)
    flags = ['-n', 'nltcs', '-k', '8', '-d', '4', '-b', '128', '-e', '1',
             '-m', '-s', '3']
    ident = TExp(**{**BASE, 'rate': 0.001}, seed=3).identifier
    (tmp_path / 'r.jsonl').write_text(json.dumps(
        {'identifier': ident, 'ok': False, 'error': 'earlier'}) + '\n')
    assert _run(tpipe, tmp_path, 'r', flags) == 1        # skipped, failed
    assert len(_joblog(tmp_path, 'r')) == 1
    assert _run(tpipe, tmp_path, 'r', flags + ['--retry-failed']) == 0
    last = _joblog(tmp_path, 'r')[-1]
    assert last['identifier'] == ident and last['ok']


def test_isolated_cells_run_in_cell_runner_processes(tmp_path):
    _write_splits(tmp_path)
    flags = ['-n', 'nltcs', '-k', '8', '-d', '4', '-b', '128', '-e', '1',
             '-r', '0.01', '-m', '--isolate', '--cell-timeout', '300']
    assert _run(tpipe, tmp_path, 'iso', flags + ['-s', '1']) == 0
    assert _run(tpipe, tmp_path, 'iso',
                flags + ['-s', '2,3', '--pack-seeds', '2']) == 0
    recs = _joblog(tmp_path, 'iso')
    assert [r['identifier'] for r in recs] == [
        TExp(**BASE, seed=1).identifier,
        TExp(**BASE, seed=2, packed_seeds=2).identifier,
        TExp(**BASE, seed=3, packed_seeds=2).identifier]
    assert all(r['ok'] and np.isfinite(r['pll_test']) for r in recs)
    # each record names its process's device and launches (the plain
    # versions on the CPU: no kernel launch)
    assert all(r['cell_process'] == {'device': 'cpu', 'launches': {
        'vq_argmin': 0, 'vq_argmin_bf16': 0, 'adam': 0, 'adam_bf16': 0,
        'ema': 0, 'recon': 0, 'first_layer': 0}}
        for r in recs)


def test_mesh_cells_fail_with_their_roadmap_item(tmp_path):
    """Mesh cells run unpacked (packing does not compose with a mesh),
    each in a world of its own ranks, under the JAX runner's identifiers;
    the joblog records the mesh, and the PLLs are the single-device
    runs'."""
    _write_splits(tmp_path, rows=(256, 64, 64))
    grid = ['-n', 'nltcs', '-k', '8', '-d', '4', '-b', '128', '-e', '1',
            '-r', '0.01', '-m', '-s', '1,2']
    assert _run(tpipe, tmp_path, 'mesh',
                grid + ['--pack-seeds', '2', '--mesh-model', '2']) == 0
    assert _run(tpipe, tmp_path, 'solo', grid) == 0
    recs, solo = _joblog(tmp_path, 'mesh'), _joblog(tmp_path, 'solo')
    assert [r['identifier'] for r in recs] == [
        JExp(**BASE, seed=s).identifier for s in (1, 2)]
    assert _result_ids(tmp_path, 'mesh') == _result_ids(tmp_path, 'solo')
    for r, one in zip(recs, solo):
        assert r['ok'] and r['mesh']['backend'] == 'gloo'
        assert r['mesh']['shape'] == [1, 2]
        assert r['mesh']['devices'] == ['cpu', 'cpu']
        assert r['mesh']['launches'] == {
            'vq_argmin': 0, 'vq_argmin_bf16': 0, 'adam': 0, 'adam_bf16': 0,
            'ema': 0, 'recon': 0, 'first_layer': 0}
        np.testing.assert_allclose(r['pll_test'], one['pll_test'],
                                   rtol=1e-6)


def test_cli_flags_equal_jax():
    """Every flag of the JAX runner, with its default."""
    def flags(parser):
        return {a.dest: a.default for a in parser._actions}
    assert flags(tpipe.build_parser()) == flags(jpipe.build_parser())


def test_cell_payload_round_trips_every_field():
    cell = TExp(**BASE, seed=4, units=(8, 6), cpt_parents_eval=(1, 2))
    from pgmvae_tpu_torch._cell_runner import _config
    back = _config(json.loads(json.dumps(dataclasses.asdict(cell))))
    assert back == cell
