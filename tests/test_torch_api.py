"""The port's public surface against the JAX package's, by an AST walk:
every public module-level function and class, and every public method of a
public class, of each JAX module (the package and its entry points: the
root `run.py`, `run_pipeline.py`, `bench.py`, `__graft_entry__.py` and the
twinned `scripts/bench_*.py`) has a counterpart of the same name in the
port's module at the same path. The allowlist holds only the omissions that
ROADMAP.md §A names, each checked to be still absent, so a stale entry
fails too. And `data.native.available()`, JAX's gate on the parser, and
the command lines' `--help`, which describes the port, not XLA on a TPU."""

import ast
import importlib
import inspect
import re
from pathlib import Path

import pytest

from pgmvae_tpu.data import native as jnative
from pgmvae_tpu_torch.data import native

ROOT = Path(__file__).resolve().parents[1]
PORT = Path('pgmvae_tpu_torch')

# JAX module -> port module, where the path differs
RENAMED = {'pgmvae_tpu/ops/pallas_vq.py': 'pgmvae_tpu_torch/ops/cuda_vq.py'}
for _name in ('run.py', 'run_pipeline.py', 'bench.py', '__graft_entry__.py'):
    RENAMED[_name] = str(PORT / _name)
for _name in ('bench_packed.py', 'bench_cmll.py', 'bench_streaming.py'):
    RENAMED[f'scripts/{_name}'] = str(PORT / _name)

# ROADMAP.md §A: the JAX package's names the port has no counterpart for.
# None: the whole module (XLA's compile cache; the port caches its nvcc
# builds in _build/).
OMITTED = {
    'pgmvae_tpu/utils/cache.py': None,
    # the optax face of the Adam kernel, and its shape helper
    'pgmvae_tpu/ops/fused_adam.py': {'FusedAdam', 'fused_adam', 'np_prod'},
    # GSPMD annotations: the port's ranks take their rows explicitly
    'pgmvae_tpu/parallel/mesh.py': {'MeshContext.constrain',
                                    'MeshContext.constrain_tree'},
    # the TPU probe and its CPU fallback, the last TPU record, the live TF2
    # run (TF is not on the card)
    'bench.py': {'probe_chip', 'last_tpu_record', 'measure_tf2_baseline'},
}


def _public(path: Path) -> set:
    """Public module-level functions and classes, and `Class.method` for
    the public methods of public classes."""
    def public(node, kinds=(ast.FunctionDef, ast.AsyncFunctionDef)):
        return isinstance(node, kinds) and not node.name.startswith('_')
    names = set()
    for node in ast.parse(path.read_text()).body:
        if public(node):
            names.add(node.name)
        elif public(node, ast.ClassDef):
            names.add(node.name)
            names.update(f'{node.name}.{sub.name}' for sub in node.body
                         if public(sub))
    return names


def _pairs() -> list:
    jax = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / 'pgmvae_tpu').rglob('*.py'))
    jax += [m for m in RENAMED if not m.startswith('pgmvae_tpu/')]
    return [(m, RENAMED.get(m, m.replace('pgmvae_tpu/', f'{PORT}/', 1)))
            for m in jax]


@pytest.mark.parametrize('jax_module,port_module', _pairs())
def test_public_names_have_a_port_counterpart(jax_module, port_module):
    jax_names = _public(ROOT / jax_module)
    omitted = OMITTED.get(jax_module, set())
    port_path = ROOT / port_module
    if jax_module in OMITTED and omitted is None:
        assert not port_path.exists(), f'{port_module} is no longer omitted'
        return
    missing = jax_names - _public(port_path) - omitted
    assert not missing, (f'{jax_module} names without a counterpart in '
                         f'{port_module}: {sorted(missing)}')
    assert omitted <= jax_names, (
        f'allowlisted names not in {jax_module}: '
        f'{sorted(omitted - jax_names)}')
    assert not omitted & _public(port_path), (
        f'allowlisted names now in {port_module}: '
        f'{sorted(omitted & _public(port_path))}')


def test_the_walk_covers_every_jax_module_and_entry_point():
    modules = [m for m, _ in _pairs()]
    assert 'pgmvae_tpu/data/native.py' in modules
    assert set(RENAMED) <= set(modules)
    assert len(modules) == len(list((ROOT / 'pgmvae_tpu').rglob('*.py'))) + 7


def test_walk_finds_a_missing_counterpart(tmp_path):
    jax = tmp_path / 'a.py'
    port = tmp_path / 'b.py'
    jax.write_text('def f():\n    pass\n\n\nclass C:\n    def m(self):\n'
                   '        pass\n\n    def _p(self):\n        pass\n')
    port.write_text('class C:\n    pass\n\n\ndef _f():\n    pass\n')
    assert _public(jax) - _public(port) == {'f', 'C.m'}


def test_native_available_is_jax_gate():
    assert inspect.signature(native.available) == inspect.signature(
        jnative.available)
    assert native.available() is (native.unavailable() is None)
    assert isinstance(native.available(), bool)


@pytest.mark.parametrize('module', ['run', 'run_pipeline'])
def test_help_names_no_tpu_behaviour(module, capsys):
    parser = importlib.import_module(f'pgmvae_tpu_torch.{module}'
                                     ).build_parser()
    with pytest.raises(SystemExit) as exit_:
        parser.parse_args(['--help'])
    assert exit_.value.code == 0
    # the flags' choices keep the JAX package's names ({xla,pallas,auto})
    text = re.sub(r'\{[^}]*\}', '{}', capsys.readouterr().out)
    assert '--vq-impl' in text and '--adam-impl' in text
    found = re.findall(r'\b(?:vmem|xla|tpu)\b', text, flags=re.IGNORECASE)
    assert not found, found
