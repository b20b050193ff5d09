"""Rules of the PyTorch/CUDA port that no parity test shows: it never
imports the JAX side (nor msgpack or ml_dtypes, which the card's machine
lacks), it runs on CUDA unless told otherwise, its kernel wrappers take the
plain versions only for CPU tensors, a missing nvcc is a clear error, the
command line runs a device mesh (its ranks spawned, the JAX identifier
written), and --profile writes a trace."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pgmvae_tpu_torch
from pgmvae_tpu_torch import driver
from pgmvae_tpu_torch import run as trun
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import _build, cuda_vq, fused_adam, kernels
from pgmvae_tpu_torch.serving import PgmModel
from pgmvae_tpu_torch.stage2 import Stage2
from pgmvae_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'flax', 'optax', 'msgpack', 'ml_dtypes', 'pgmvae_tpu')
CFG = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=5)

# A meta-path finder that refuses the JAX side by exact name or dotted
# prefix: 'pgmvae_tpu' and 'pgmvae_tpu.x' are blocked, 'pgmvae_tpu_torch'
# is not.
_BLOCKER = '''
import importlib, pkgutil, sys
BLOCKED = {blocked!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            raise ImportError('blocked import of ' + name)
        return None
sys.meta_path.insert(0, Block())
import pgmvae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pgmvae_tpu_torch.__path__, 'pgmvae_tpu_torch.')]
for name in names:
    importlib.import_module(name)
assert not any(m == b or m.startswith(b + '.')
               for m in sys.modules for b in BLOCKED)
print(len(names))
'''


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(pgmvae_tpu_torch.__path__,
                                                  'pgmvae_tpu_torch.')]


def test_port_imports_without_jax_side():
    env = {**os.environ, 'PYTHONPATH': ROOT}
    out = subprocess.run([sys.executable, '-c',
                          _BLOCKER.format(blocked=BLOCKED)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_port_modules()) >= 21
    assert {'pgmvae_tpu_torch.' + m for m in (
        'ops._build', 'ops.fused_adam', 'train', 'driver', 'run',
        'utils.logging', 'checkpoint', 'utils.msgpack', 'gibbs',
        'run_pipeline', '_cell_runner', 'graphs', 'parallel',
        'parallel.mesh', 'data.native', '__graft_entry__', 'bench',
        'bench_packed', 'bench_cmll', 'data.synthetic', 'bench_streaming',
        'data.pinned')
            } <= set(_port_modules())


def test_no_import_line_names_the_jax_side():
    pattern = re.compile(r'^\s*(from|import)\s+(jax|flax|optax|msgpack|'
                         r'ml_dtypes|pgmvae_tpu)(\.|\s|$)', re.M)
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(pgmvae_tpu_torch.__path__[0]):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    for path in files:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params, codebook = tv.init_model(torch.Generator().manual_seed(0), CFG,
                                     device='cpu')
    dist = np.full((6, 5), 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tv.init_model(torch.Generator().manual_seed(0), CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Stage2(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PgmModel(CFG, params, codebook, dist)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, 0.01, 8, 40)
    assert pgmvae_tpu_torch.resolve_device('cpu') == torch.device('cpu')


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((4, 33, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6, 70)).astype(np.float32))
    before = kernels.counts()['vq_argmin']
    got = cuda_vq.vq_codes_fused(z, w)
    assert kernels.counts()['vq_argmin'] == before == 0
    assert got.dtype == torch.int32 and got.shape == (4, 33)
    np.testing.assert_array_equal(got.numpy(),
                                  cuda_vq.vq_codes_plain(z, w).numpy())
    ref = ((w * w).sum(1, keepdim=True) - 2 * z @ w).argmin(-1)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize('z_shape,w_shape,dtype,match', [
    ((2, 3, 4), (2, 5, 6), torch.float32, 'does not match'),
    ((2, 3, 4), (3, 4, 6), torch.float32, 'does not match'),
    ((3, 4), (2, 4, 6), torch.float32, r'\[n, B, D\]'),
    ((2, 3, 4), (2, 4, 6), torch.float64, 'float32'),
    ((2, 3, 4), (2, 4, 0), torch.float32, 'no codes'),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(z_shape, w_shape,
                                                       dtype, match):
    with pytest.raises(ValueError, match=match):
        cuda_vq.vq_codes_fused(torch.zeros(z_shape, dtype=dtype),
                               torch.zeros(w_shape, dtype=dtype))


def test_wrapper_refuses_mixed_input_types():
    with pytest.raises(ValueError, match='the same for z and codebook'):
        cuda_vq.vq_codes_fused(torch.zeros((2, 3, 4)),
                               torch.zeros((2, 4, 5), dtype=torch.bfloat16))


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    z = torch.zeros((2, 3, 4), device='meta')
    w = torch.zeros((2, 4, 5), device='meta')
    with pytest.raises(ValueError, match='CUDA or CPU'):
        cuda_vq.vq_codes_fused(z, w)


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_vq, '_lib', None)
    monkeypatch.setattr(fused_adam, '_lib', None)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(_build, 'DEFAULT_NVCC', str(tmp_path / 'no-nvcc'))
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)


def test_build_without_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    for module, name in ((cuda_vq, 'vq_argmin'), (fused_adam, 'adam')):
        with pytest.raises(RuntimeError, match=f'nvcc not found.*{name}'):
            module.build()
    assert not (tmp_path / '_build').exists()


def test_kernels_build_for_sm90a_and_adam_without_fma(monkeypatch,
                                                      tmp_path):
    """Each kernel's nvcc line: Hopper's sm_90a, the source of the repo,
    -fmad=false for adam only (its bit-equality with the plain version
    rests on it), and never --use_fast_math. A failing compiler stands in
    for nvcc, so the line comes back in the error."""
    _no_nvcc(monkeypatch, tmp_path)
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\nexit 3\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, 'DEFAULT_NVCC', str(fake))
    for module, src, fmad in ((cuda_vq, 'vq_argmin.cu', False),
                              (fused_adam, 'adam.cu', True)):
        with pytest.raises(RuntimeError, match='nvcc failed with code 3') as e:
            module.build()
        cmd = str(e.value).splitlines()[0]
        assert 'arch=compute_90a,code=sm_90a' in cmd and cmd.endswith(src)
        assert ('-fmad=false' in cmd) is fmad
        assert 'fast_math' not in cmd
        assert module.library_path().parent == tmp_path / '_build'
    assert cuda_vq.library_path() != fused_adam.library_path()


def test_adam_on_cpu_tensors_launches_nothing():
    params = {'enc': [(torch.ones((2, 3, 4)), torch.zeros((2, 1, 4)))]}
    grads = tv.map_params(lambda p: torch.full_like(p, 0.5), params)
    st = fused_adam.adam_init(params, 0.01)
    before = kernels.counts()['adam']
    st = fused_adam.adam_update(params, grads, st)
    assert kernels.counts()['adam'] == before == 0
    assert int(st.count) == 1
    # the first step moves every parameter by lr against its gradient
    np.testing.assert_allclose(params['enc'][0][0].numpy(), 0.99, rtol=1e-5)


@pytest.mark.parametrize('kind', ['bf16'])
def test_trainer_refuses_what_is_not_ported(kind):
    """The trainer refuses an unknown adam_impl or compute_dtype; bf16
    compute, packed seeds and streamed data, refused before they were
    ported, now construct and run a step."""
    with pytest.raises(ValueError, match='unknown adam_impl'):
        Trainer(CFG, 0.01, 8, 40, adam_impl='sgd', device='cpu')
    with pytest.raises(ValueError, match='unknown compute_dtype'):
        Trainer(CFG._replace(compute_dtype='fp8'), 0.01, 8, 40,
                device='cpu')
    y = np.random.default_rng(0).integers(0, 2, (8, 6)).astype(np.float32)
    tr = Trainer(CFG._replace(compute_dtype=kind), 0.01, 8, 8, device='cpu')
    state, hist = tr.fit(tr.init_state(0), y, 1, seed=0)
    assert int(state.step) == 1 and np.isfinite(hist[0].loss)
    states, ms = tr.fit_packed(tr.init_states_packed([0, 1]), y, 1, [0, 1])
    assert states.step.tolist() == [1, 1] and np.isfinite(ms.loss).all()
    streamed = Trainer(CFG, 0.01, 8, 8, stream_bytes=y.nbytes - 1,
                       device='cpu')
    state, hist = streamed.fit(streamed.init_state(0), y, 1, seed=0)
    assert int(state.step) == 1 and np.isfinite(hist[0].loss)


def _write_nltcs_like(root, rows=(64, 16, 16)):
    rng = np.random.default_rng(0)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < 0.4).astype(np.uint8)
        with open(root / f'nltcs.{split}.data', 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


UNPORTED = [
    (['--mesh-model', '2'], dict(mesh_model=2), 'model'),
    (['--mesh-data', '2'], dict(mesh_data=2), 'data'),
]


@pytest.mark.parametrize('flags,fields,item', UNPORTED)
def test_unported_features_raise_and_the_cli_exits_2(flags, fields, item,
                                                     capsys, tmp_path,
                                                     monkeypatch):
    """A device mesh on the command line: the CLI spawns its two ranks
    (gloo on the CPU), names the mesh on stderr, and writes the JAX
    identifier (no mesh suffix) with the single-device run's PLLs."""
    _write_nltcs_like(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ['-n', 'nltcs', '-k', '5', '-d', '3', '-b', '32', '-e', '1',
            '-m', '--device', '-1', '--data-dir', str(tmp_path)]
    rc = trun.main(base + ['--result-file', str(tmp_path / 'r.txt')]
                   + flags)
    assert rc == 0
    err = capsys.readouterr().err
    assert 'mesh: ' in err and '"backend": "gloo"' in err, err[-2000:]
    ident, *plls = (tmp_path / 'r.txt').read_text().split()
    exp = driver.ExperimentConfig(name='nltcs', embedding=5, dim=3,
                                  batch=32, epoch=1, ema=True,
                                  data_dir=str(tmp_path))
    assert ident == exp.identifier
    one = driver.run_experiment(exp, device='cpu')
    got = [float(p.split(':')[1]) for p in plls[:3]]
    np.testing.assert_allclose(
        got, [one['pll_train'], one['pll_valid'], one['pll_test']],
        rtol=1e-6, err_msg=item)


def test_cli_profile_writes_a_trace(tmp_path, monkeypatch):
    """--profile (as the JAX CLI's, run.py:230-234) wraps the run in a
    torch.profiler trace, written as Chrome trace JSON into the run's log
    directory; the run's result line is written as without it."""
    import json
    rng = np.random.default_rng(0)
    for split, rows in (('train', 64), ('valid', 16), ('test', 16)):
        y = (rng.random((rows, 16)) < 0.4).astype(np.uint8)
        with open(tmp_path / f'nltcs.{split}.data', 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')
    monkeypatch.chdir(tmp_path)
    rc = trun.main(['-n', 'nltcs', '-k', '5', '-d', '3', '-b', '32', '-e',
                    '1', '-m', '--device', '-1', '--data-dir', str(tmp_path),
                    '--result-file', str(tmp_path / 'r.txt'), '--profile'])
    assert rc == 0
    ident = (tmp_path / 'r.txt').read_text().split(' ', 1)[0]
    trace = tmp_path / 'logs' / 'tuning' / ident / 'trace.json'
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert any('aten::' in str(n) for n in names), sorted(map(str, names))[:20]
