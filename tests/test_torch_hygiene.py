"""Rules of the PyTorch/CUDA port that no parity test shows: it never
imports the JAX side, it runs on CUDA unless told otherwise, its kernel
wrapper takes the plain version only for CPU tensors, and a missing nvcc is
a clear error."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pgmvae_tpu_torch
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_vq
from pgmvae_tpu_torch.serving import PgmModel
from pgmvae_tpu_torch.stage2 import Stage2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ('jax', 'flax', 'optax', 'pgmvae_tpu')
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
    assert int(out.stdout.strip()) == len(_port_modules()) >= 12


def test_no_import_line_names_the_jax_side():
    pattern = re.compile(r'^\s*(from|import)\s+(jax|flax|optax|pgmvae_tpu)'
                         r'(\.|\s|$)', re.M)
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
    assert pgmvae_tpu_torch.resolve_device('cpu') == torch.device('cpu')


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((4, 33, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6, 70)).astype(np.float32))
    before = cuda_vq.LAUNCHES
    got = cuda_vq.vq_codes_fused(z, w)
    assert cuda_vq.LAUNCHES == before == 0
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


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    z = torch.zeros((2, 3, 4), device='meta')
    w = torch.zeros((2, 4, 5), device='meta')
    with pytest.raises(ValueError, match='CUDA or CPU'):
        cuda_vq.vq_codes_fused(z, w)


def test_build_without_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_vq, '_lib', None)
    monkeypatch.setattr(cuda_vq, '_BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(cuda_vq, '_DEFAULT_NVCC', str(tmp_path / 'no-nvcc'))
    monkeypatch.setattr(cuda_vq.shutil, 'which', lambda name: None)
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    with pytest.raises(RuntimeError, match='nvcc not found'):
        cuda_vq.build()
    assert not (tmp_path / '_build').exists()
