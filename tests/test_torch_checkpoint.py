"""The port's checkpoints (`pgmvae_tpu_torch/checkpoint.py`) against the
JAX package's (`pgmvae_tpu/checkpoint.py`): for every quantizer and every
adam_impl, a JAX-written file loads into the port as `train_state_from_jax`
gives the state, the port writes the same bytes for the same state, CPT and
extra, and JAX loads the port's file; chunked arrays both ways; raw loads;
refusals; and a loaded state trains."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from pgmvae_tpu import checkpoint as jckpt
from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.ops.fused_adam import fused_adam
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch import checkpoint as tckpt
from pgmvae_tpu_torch.convert import train_state_from_jax
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.train import Trainer

KW = dict(n_var=5, units=(4, 3), dim=2, num_codes=4)
EXTRA = {'identifier': 'nltcs_K-4_D-2', 'pll': {'train': -3.25, 'test': -3.5},
         'cpt_parents': [[1], [0], [0], [2], [3]]}


def _jax_trained(quantizer, adam_impl, seed=0):
    """A JAX TrainState after one epoch of 3 steps; its optax-layout outer
    count set to the step count (the JAX package's fused updates leave it
    at 0; the port writes the step count there, and nothing reads it)."""
    jcfg = JCfg(**KW, quantizer=quantizer)
    tr = JTrainer(jcfg, 0.01, 8, 24, adam_impl=adam_impl)
    if adam_impl == 'pallas':       # the Pallas kernel runs interpreted here
        tr._fused_adam = fused_adam(0.01, eps=1e-7, impl='pallas',
                                    interpret=True)
    st = tr.init_state(jax.random.PRNGKey(seed))
    y = np.random.default_rng(seed).integers(0, 2, (24, 5)).astype(np.float32)
    st, _ = tr.run_epoch(st, jnp.asarray(y), jax.random.PRNGKey(1))
    inner = st.opt_state.inner_state[0]
    return jcfg, tr, st._replace(
        opt_state=st.opt_state._replace(count=inner.count))


def _port_leaves(st):
    opt = st.opt_state
    return (tv.param_leaves(st.params) + list(st.ema or ())
            + tv.param_leaves(opt.mu) + tv.param_leaves(opt.nu)
            + [opt.count, opt.learning_rate, st.step])


def _assert_same(a, b):
    for x, y in zip(_port_leaves(a), _port_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    assert a.opt_state.eps == b.opt_state.eps


@pytest.mark.parametrize('adam_impl', ['optax', 'pallas', 'fused_bf16'])
@pytest.mark.parametrize('quantizer', ['ema', 'vq', 'naive'])
def test_files_cross_both_ways_byte_for_byte(quantizer, adam_impl,
                                             tmp_path):
    jcfg, jtr, js = _jax_trained(quantizer, adam_impl)
    cfg = tv.VqVaeConfig(**KW, quantizer=quantizer)
    dist = np.random.default_rng(1).uniform(size=(5, 4))
    jpath, tpath = str(tmp_path / 'j.ckpt'), str(tmp_path / 't.ckpt')
    jckpt.save(jpath, jcfg, js, dist, extra=EXTRA)

    # the JAX file in the port: the state train_state_from_jax gives
    ref = train_state_from_jax(jax.tree.map(np.asarray, js), cfg, 'cpu')
    template = Trainer(cfg, 0.01, 8, 24, adam_impl=adam_impl,
                       device='cpu').init_state(3)
    got_cfg, got, got_dist, extra = tckpt.load(jpath, state_template=template)
    assert got_cfg == cfg and extra == EXTRA
    np.testing.assert_array_equal(got_dist, dist)
    _assert_same(got, ref)
    moments = torch.bfloat16 if adam_impl == 'fused_bf16' else torch.float32
    assert got.opt_state.mu['enc'][0][0].dtype == moments

    # the same state, CPT and extra written by the port: the same bytes
    tckpt.save(tpath, cfg, ref, dist, extra=EXTRA)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        assert a.read() == b.read()

    # and the JAX package restores the port's file
    _, back, back_dist, _ = jckpt.load(
        tpath, state_template=jtr.init_state(jax.random.PRNGKey(9)))
    np.testing.assert_array_equal(back_dist, dist)
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(js)
    assert len(leaves) == len(ref_leaves)
    for x, y in zip(leaves, ref_leaves):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_jax_fused_outer_count_is_ignored(tmp_path):
    """A file from the JAX package's fused update (outer count left at 0)
    loads to the same state as one whose outer count was aligned."""
    jcfg, _, js = _jax_trained('ema', 'fused')
    path = str(tmp_path / 'j.ckpt')
    jckpt.save(path, jcfg, js._replace(opt_state=js.opt_state._replace(
        count=jnp.zeros((), jnp.int32))))
    cfg = tv.VqVaeConfig(**KW)
    template = Trainer(cfg, 0.01, 8, 24, device='cpu').init_state(0)
    _, got, dist, extra = tckpt.load(path, state_template=template)
    assert dist is None and extra == {}
    _assert_same(got, train_state_from_jax(jax.tree.map(np.asarray, js),
                                           cfg, 'cpu'))
    assert int(got.opt_state.count) == 3


@pytest.mark.parametrize('adam_impl', ['optax', 'fused_bf16'])
def test_chunked_arrays_both_ways(adam_impl, tmp_path, monkeypatch):
    """Arrays past MAX_CHUNK_SIZE bytes are written as flax's chunk maps:
    with both packages' limit set to 24 bytes, the bytes are equal and
    each side reads the other's chunks (bfloat16 chunks included)."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 24)
    monkeypatch.setattr(tckpt, 'MAX_CHUNK_SIZE', 24)
    jcfg, jtr, js = _jax_trained('vq', adam_impl, seed=4)
    cfg = tv.VqVaeConfig(**KW, quantizer='vq')
    dist = np.random.default_rng(2).uniform(size=(5, 4))
    jpath, tpath = str(tmp_path / 'j.ckpt'), str(tmp_path / 't.ckpt')
    jckpt.save(jpath, jcfg, js, dist)
    ref = train_state_from_jax(jax.tree.map(np.asarray, js), cfg, 'cpu')
    tckpt.save(tpath, cfg, ref, dist)
    with open(jpath, 'rb') as a, open(tpath, 'rb') as b:
        blob = a.read()
        assert blob == b.read()
    assert b'__msgpack_chunked_array__' in blob
    template = Trainer(cfg, 0.01, 8, 24, adam_impl=adam_impl,
                       device='cpu').init_state(0)
    _, got, got_dist, _ = tckpt.load(jpath, state_template=template)
    _assert_same(got, ref)
    np.testing.assert_array_equal(got_dist, dist)
    _, back, _, _ = jckpt.load(
        tpath, state_template=jtr.init_state(jax.random.PRNGKey(9)))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_raw_load_matches_jax_and_resaves_the_same_bytes(tmp_path):
    jcfg, _, js = _jax_trained('vq', 'fused_bf16', seed=3)
    path = str(tmp_path / 'm.ckpt')
    jckpt.save(path, jcfg, js)
    cfg, raw, dist, extra = tckpt.load(path)
    assert dist is None and cfg.quantizer == 'vq' and extra == {}
    # the raw dict still exposes the codebook param for inference-only use
    assert 'params' in raw and 'codebook' in raw['params']
    _, jraw, _, _ = jckpt.load(path)
    np.testing.assert_array_equal(raw['params']['codebook'],
                                  jraw['params']['codebook'])
    mu = raw['opt_state']['inner_state']['0']['mu']['enc']['0']['0']
    jmu = jraw['opt_state']['inner_state']['0']['mu']['enc']['0']['0']
    assert mu.dtype == torch.bfloat16
    np.testing.assert_array_equal(mu.view(torch.int16).numpy(),
                                  np.asarray(jmu).view(np.int16))
    again = str(tmp_path / 'again.ckpt')
    tckpt.save(again, cfg, raw)
    with open(path, 'rb') as a, open(again, 'rb') as b:
        assert a.read() == b.read()


def test_rejects_garbage(tmp_path):
    p = tmp_path / 'bad.ckpt'
    p.write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match='not a pgmvae checkpoint'):
        tckpt.load(str(p))


@pytest.mark.parametrize('field,value', [('b1', 0.8), ('b2', 0.99),
                                         ('eps_root', 1e-8)])
def test_refuses_adam_constants_the_kernel_does_not_take(field, value,
                                                         tmp_path):
    cfg = tv.VqVaeConfig(**KW)
    st = Trainer(cfg, 0.01, 8, 24, device='cpu').init_state(0)
    tree = tckpt.state_dict(st)
    tree['opt_state']['hyperparams'][field] = np.asarray(value, np.float32)
    path = str(tmp_path / 'm.ckpt')
    tckpt.save(path, cfg, tree)
    with pytest.raises(ValueError, match=f'{field}='):
        tckpt.load(path, state_template=st)


def test_refuses_a_template_of_another_structure(tmp_path):
    cfg = tv.VqVaeConfig(**KW)
    st = Trainer(cfg, 0.01, 8, 24, device='cpu').init_state(0)
    path = str(tmp_path / 'm.ckpt')
    tckpt.save(path, cfg, st)
    other = Trainer(cfg._replace(quantizer='vq'), 0.01, 8, 24,
                    device='cpu').init_state(0)
    with pytest.raises(ValueError, match='template'):
        tckpt.load(path, state_template=other)


@pytest.mark.parametrize('adam_impl', ['optax', 'fused_bf16'])
def test_loaded_state_trains_a_step(adam_impl, tmp_path):
    jcfg, _, js = _jax_trained('ema', adam_impl, seed=5)
    path = str(tmp_path / 'm.ckpt')
    jckpt.save(path, jcfg, js)
    cfg = tv.VqVaeConfig(**KW)
    tr = Trainer(cfg, 0.01, 8, 24, adam_impl=adam_impl, device='cpu')
    _, st, _, _ = tckpt.load(path, state_template=tr.init_state(1))
    before = [p.clone() for p in tv.param_leaves(st.params)]
    st, m = tr.train_step(st, torch.ones((8, 5)), torch.ones(8))
    assert int(st.step) == int(st.opt_state.count) == 4
    assert torch.isfinite(m).all()
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tv.param_leaves(st.params)))
