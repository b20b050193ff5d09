"""The port's package-level names and data directory against the JAX
package's: every name the JAX package's `__init__` files export imports
from the port's counterpart, the
leave-one-out table and views are JAX's, `registry.data_dir` searches
the same candidates in the same order, and the public constructors and
functions take the JAX package's parameters in its order."""

import ast
import importlib
import os

import numpy as np
import pytest

import pgmvae_tpu
import pgmvae_tpu.data.loader as jloader
import pgmvae_tpu.registry as jregistry
import pgmvae_tpu_torch.data.loader as tloader
import pgmvae_tpu_torch.registry as tregistry

PACKAGES = ['', '.models', '.ops', '.data', '.utils', '.parallel']


def _exported(module_name: str) -> list:
    """The names a JAX package `__init__` imports from its modules."""
    path = importlib.util.find_spec(module_name).origin
    with open(path) as f:
        tree = ast.parse(f.read())
    return [alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


@pytest.mark.parametrize('sub', PACKAGES)
def test_every_jax_package_name_imports_from_the_port(sub):
    names = _exported('pgmvae_tpu' + sub)
    assert names, sub
    port = importlib.import_module('pgmvae_tpu_torch' + sub)
    jax_side = importlib.import_module('pgmvae_tpu' + sub)
    for name in names:
        mine, ref = getattr(port, name), getattr(jax_side, name)
        assert callable(mine) == callable(ref), name
        if callable(mine):
            assert mine.__module__.startswith('pgmvae_tpu_torch.'), (
                name, mine.__module__)
        else:                             # REGISTRY: the same datasets
            assert mine.keys() == ref.keys(), name


def test_the_registry_names_are_the_same_objects_as_the_modules():
    import pgmvae_tpu_torch
    assert pgmvae_tpu_torch.REGISTRY is tregistry.REGISTRY
    assert pgmvae_tpu_torch.REGISTRY.keys() == pgmvae_tpu.REGISTRY.keys()
    assert pgmvae_tpu_torch.default_units(1058, 20) == \
        pgmvae_tpu.default_units(1058, 20)


@pytest.mark.parametrize('n_var', [2, 5, 16, 64])
def test_leave_one_out_equals_jax(n_var):
    got = tloader.leave_one_out_index(n_var)
    ref = jloader.leave_one_out_index(n_var)
    assert got.dtype == ref.dtype and got.shape == (n_var, n_var - 1)
    np.testing.assert_array_equal(got, ref)
    y = np.random.default_rng(n_var).integers(0, 2, (7, n_var)).astype(
        np.float32)
    views = tloader.leave_one_out(y)
    assert views.shape == (n_var, 7, n_var - 1)
    np.testing.assert_array_equal(views, jloader.leave_one_out(y))


@pytest.mark.parametrize('present', [
    ('env',), ('cwd',), ('mount',), ('cwd', 'mount'), ('env', 'mount'),
    ()])
def test_data_dir_searches_what_jax_searches(present, monkeypatch):
    """$PGMVAE_DATA_DIR, ./data/trw, then the benchmark mount: the first
    that is a directory wins, as in the JAX package; none raises."""
    env = os.path.join(os.sep, 'data-dir-from-env')
    monkeypatch.setenv('PGMVAE_DATA_DIR', env)
    cands = {'env': env, 'cwd': os.path.join(os.curdir, 'data', 'trw'),
             'mount': tregistry.REFERENCE_DATA_DIR}
    dirs = {cands[k] for k in present}
    monkeypatch.setattr(os.path, 'isdir', lambda p: p in dirs)
    if not present:
        for reg in (tregistry, jregistry):
            with pytest.raises(FileNotFoundError, match='PGMVAE_DATA_DIR'):
                reg.data_dir()
        return
    assert tregistry.data_dir() == jregistry.data_dir() == cands[present[0]]


# ---------------------------------- the public signatures against JAX --

# (JAX module:function, port module:function); a class stands for its
# __init__
SIGNATURES = [
    ('pgmvae_tpu.train:Trainer', 'pgmvae_tpu_torch.train:Trainer'),
    ('pgmvae_tpu.stage2:Stage2', 'pgmvae_tpu_torch.stage2:Stage2'),
    ('pgmvae_tpu.serving:PgmModel', 'pgmvae_tpu_torch.serving:PgmModel'),
    ('pgmvae_tpu.gibbs:get_probability',
     'pgmvae_tpu_torch.gibbs:get_probability'),
    ('pgmvae_tpu.gibbs:conditional_marginal_log_likelihood',
     'pgmvae_tpu_torch.gibbs:conditional_marginal_log_likelihood'),
    ('pgmvae_tpu.checkpoint:save', 'pgmvae_tpu_torch.checkpoint:save'),
    ('pgmvae_tpu.checkpoint:load', 'pgmvae_tpu_torch.checkpoint:load'),
]
# the one rename: a JAX PRNG key is a torch.Generator in the port
RENAMED = {'key': 'generator'}
# the one departure: the JAX package's Stage2 takes `scatter`, its choice
# of count path; the port counts by one path, and every parameter after
# `parents` is keyword-only, so a JAX-style positional `scatter` raises
DEPARTED = {'pgmvae_tpu_torch.stage2:Stage2': ('scatter',)}


def _parameters(spec: str) -> list:
    import inspect
    module, name = spec.split(':')
    obj = getattr(importlib.import_module(module), name)
    params = list(inspect.signature(obj).parameters.values())
    if inspect.isclass(obj) and params[:1] and params[0].name == 'self':
        params = params[1:]
    return params


@pytest.mark.parametrize('jax_spec,port_spec', SIGNATURES,
                         ids=[s[1].split(':')[1] for s in SIGNATURES])
def test_public_signatures_lead_with_the_jax_parameters(jax_spec,
                                                        port_spec):
    """Every parameter of the JAX function, in order, leads the port's
    (the port's own extras, such as `device` and `graphs`, follow), so a
    positional call means the same in both packages. A departed parameter
    is absent, and what follows its place is keyword-only."""
    import inspect
    departed = DEPARTED.get(port_spec, ())
    jax_names = [p.name for p in _parameters(jax_spec)]
    ref = [RENAMED.get(p, p) for p in jax_names if p not in departed]
    got = _parameters(port_spec)
    assert [p.name for p in got[:len(ref)]] == ref, (got, ref)
    assert set(departed) <= set(jax_names)
    assert not set(departed) & {p.name for p in got}
    if departed:
        assert all(p.kind == inspect.Parameter.KEYWORD_ONLY
                   for p in got[len(ref):]), got
