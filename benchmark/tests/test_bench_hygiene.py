"""Nothing under benchmark/ imports the JAX stack or the JAX package (top-
level module names compared whole: the port's name begins with the JAX
package's), and the plain reference, the inputs and the yardstick import
nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob('*.py'))
# the modules that must stand apart from the program
APART = ('reference.py', 'inputs.py', 'work.py')


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(
    BENCH_DIR)))
def test_no_jax_import(path):
    assert not imported(path) & set(harness.BANNED)


@pytest.mark.parametrize('name', APART)
def test_apart_from_the_program(name):
    assert 'pgmvae_tpu_torch' not in imported(BENCH_DIR / name)


def test_reference_loads_with_the_program_blocked():
    code = ('import sys\n'
            'class Block:\n'
            '    def find_spec(self, name, path=None, target=None):\n'
            '        if name.split(".")[0] in ("pgmvae_tpu_torch",\n'
            '                                  *BANNED):\n'
            '            raise ImportError(name)\n'
            'from benchmark.harness import BANNED\n'
            'sys.meta_path.insert(0, Block())\n'
            'import benchmark.reference, benchmark.inputs, benchmark.work\n'
            'found = {m.split(".")[0] for m in sys.modules}\n'
            'assert not found & {"pgmvae_tpu_torch", *BANNED}, found\n')
    proc = subprocess.run([sys.executable, '-c', code],
                          cwd=BENCH_DIR.parent, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_banned_names_are_whole():
    assert 'pgmvae_tpu_torch' not in harness.BANNED
    assert {'jax', 'jaxlib', 'flax', 'pgmvae_tpu'} <= set(harness.BANNED)
