"""The port's Adam update (`adam_update_plain`, the CUDA kernel's plain
version, which `adam_update` runs for CPU tensors) against the JAX
package's Pallas kernel in interpret mode, its fused XLA path and optax,
with the contract of tests/test_fused_adam.py: rtol 1e-5, atol 1e-9, over
4 steps. The bias corrections 1 - b**t are computed by two different pow
implementations, which may differ by 1 ULP, so parity is a tolerance.

bfloat16 moments (adam_impl 'fused_bf16') against the JAX package's
'xla_bf16' update over 3 steps: params to 1e-6 relative, moments within one
bfloat16 ULP (a float32 ULP of difference before the rounding can land on
either side of a bfloat16 rounding boundary); and the Trainer's
'fused_bf16' step against the JAX Trainer's."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.ops.fused_adam import fused_adam
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu_torch.convert import (train_state_from_jax,
                                      train_state_to_numpy)
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.models.vqvae import param_leaves
from pgmvae_tpu_torch.ops import fused_adam as tfa
from pgmvae_tpu_torch.ops import kernels
from pgmvae_tpu_torch.train import Trainer

SHAPES = [(7, 9, 5), (7, 5, 5), (3, 4), (11,)]   # tests/test_fused_adam.py
LR, EPS = 3e-3, 1e-7


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    leaves = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in SHAPES]
    # the params layout: stacks of (w, b) layers
    return {'enc': [(leaves[0], leaves[1])], 'dec': [(leaves[2], leaves[3])]}


def _torch(tree):
    return {k: [tuple(torch.from_numpy(x.copy()) for x in layer)
                for layer in v] for k, v in tree.items()}


def _check(got_tree, ref_tree, msg):
    ref = jax.tree.leaves(ref_tree)
    got = param_leaves(got_tree)
    assert len(got) == len(ref) == len(SHAPES)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-9, err_msg=msg)


@pytest.mark.parametrize('ref_impl', ['pallas', 'xla', 'optax'])
def test_plain_update_matches_jax(ref_impl):
    params = _tree(0, 0.1)
    if ref_impl == 'optax':
        ref = optax.inject_hyperparams(optax.adam)(learning_rate=LR, eps=EPS)
    else:
        ref = fused_adam(LR, eps=EPS, impl=ref_impl,
                         interpret=ref_impl == 'pallas')
    jp = jax.tree.map(jnp.asarray, params)
    js = ref.init(jp)
    tp = _torch(params)
    ts = tfa.adam_init(tp, LR, EPS)
    for t in range(4):
        grads = _tree(100 + t, 0.01)
        if ref_impl == 'optax':
            u, js = ref.update(grads, js, jp)
            jp = optax.apply_updates(jp, u)
        else:
            jp, js = ref.apply(grads, js, jp)
        ts = tfa.adam_update_plain(tp, _torch(grads), ts)
        _check(tp, jp, f'params after step {t}')
    inner = js.inner_state[0]
    _check(ts.mu, inner.mu, 'mu')
    _check(ts.nu, inner.nu, 'nu')
    assert int(ts.count) == int(inner.count) == 4
    assert ts.count.dtype == torch.int32


def test_cpu_update_is_the_plain_version_bit_for_bit():
    params, grads = _tree(1, 0.1), _tree(2, 0.01)
    pa, pb = _torch(params), _torch(params)
    sa, sb = tfa.adam_init(pa, LR, EPS), tfa.adam_init(pb, LR, EPS)
    for _ in range(3):
        sa = tfa.adam_update(pa, _torch(grads), sa)
        sb = tfa.adam_update_plain(pb, _torch(grads), sb)
    for a, b in zip(param_leaves(pa) + param_leaves(sa.mu)
                    + param_leaves(sa.nu),
                    param_leaves(pb) + param_leaves(sb.mu)
                    + param_leaves(sb.nu)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_learning_rate_is_a_runtime_value():
    params, grads = _tree(3, 0.1), _tree(4, 0.01)
    tp = _torch(params)
    st = tfa.adam_init(tp, LR, EPS)
    st = st._replace(learning_rate=torch.tensor(0.0))
    tfa.adam_update(tp, _torch(grads), st)
    for a, b in zip(param_leaves(tp), param_leaves(_torch(params))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bias_corrections_match_optax_within_an_ulp():
    count = torch.arange(1, 200, dtype=torch.int32)
    got = tfa._scalars(count, torch.full((199,), LR), 0.9, 0.999)
    for b, row in ((0.9, got[0]), (0.999, got[1])):
        ref = 1.0 - jnp.asarray(b, jnp.float32) ** jnp.arange(1, 200)
        # b**t lies in (0, 1), where one float32 ULP is at most 2**-24
        np.testing.assert_allclose(row.numpy(), np.asarray(ref), rtol=0,
                                   atol=2.0 ** -24)


@pytest.mark.parametrize('case,match', [
    ('float64', 'float32'), ('shape', 'shapes differ'),
    ('strided', 'contiguous'), ('leaves', 'differ in their leaves'),
    ('mixed_moments', 'of one dtype')])
def test_update_rejects_what_the_kernel_does_not_take(case, match):
    params = _torch(_tree(5, 0.1))
    st = tfa.adam_init(params, LR, EPS)
    grads = _torch(_tree(6, 0.01))
    w = grads['enc'][0][0]
    if case == 'float64':
        grads['enc'][0] = (w.double(), grads['enc'][0][1])
    elif case == 'shape':
        grads['enc'][0] = (w[:, :, :4].contiguous(), grads['enc'][0][1])
    elif case == 'strided':
        grads['enc'][0] = (w.transpose(0, 1).contiguous().transpose(0, 1),
                           grads['enc'][0][1])
    elif case == 'mixed_moments':
        mu = st.mu['enc'][0]
        st.mu['enc'][0] = (mu[0].to(torch.bfloat16), mu[1])
    else:
        grads['codebook'] = torch.zeros(3)
    with pytest.raises(ValueError, match=match):
        tfa.adam_update(params, grads, st)


def test_update_refuses_devices_it_has_no_kernel_for():
    params = {'enc': [(torch.zeros((2, 3), device='meta'),
                       torch.zeros((2, 1), device='meta'))]}
    st = tfa.AdamState(torch.zeros((), dtype=torch.int32, device='meta'),
                       params, params, torch.zeros((), device='meta'), 1e-7)
    with pytest.raises(ValueError, match='CUDA or CPU'):
        tfa.adam_update(params, params, st)


# ------------------------------------------------- bfloat16 moments --

def _within_a_bf16_ulp(got, ref, msg):
    """|got - ref| <= one bfloat16 ULP of ref (8 significant bits)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = np.ldexp(np.float32(1.0), np.frexp(ref)[1] - 8)
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), (msg, got[bad][:5], ref[bad][:5])


def test_bf16_plain_update_matches_jax_xla_bf16():
    params = _tree(0, 0.1)
    ref = fused_adam(LR, eps=EPS, impl='xla_bf16')
    jp = jax.tree.map(jnp.asarray, params)
    js = ref.init(jp)
    tp = _torch(params)
    ts = tfa.adam_init(tp, LR, EPS, moment_dtype=torch.bfloat16)
    for t in range(3):
        grads = _tree(100 + t, 0.01)
        jp, js = ref.apply(grads, js, jp)
        ts = tfa.adam_update_plain(tp, _torch(grads), ts)
        for got, r in zip(param_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f'params after step {t}')
    inner = js.inner_state[0]
    for name, mine, theirs in (('mu', ts.mu, inner.mu),
                               ('nu', ts.nu, inner.nu)):
        for got, r in zip(param_leaves(mine), jax.tree.leaves(theirs)):
            assert got.dtype == torch.bfloat16
            assert str(np.asarray(r).dtype) == 'bfloat16'
            _within_a_bf16_ulp(got.float().numpy(),
                               np.asarray(r).astype(np.float32), name)
    assert int(ts.count) == int(inner.count) == 3


def test_bf16_cpu_update_is_the_plain_version_bit_for_bit():
    params, grads = _tree(1, 0.1), _tree(2, 0.01)
    pa, pb = _torch(params), _torch(params)
    sa = tfa.adam_init(pa, LR, EPS, moment_dtype=torch.bfloat16)
    sb = tfa.adam_init(pb, LR, EPS, moment_dtype=torch.bfloat16)
    before = kernels.counts()['adam_bf16']
    for _ in range(3):
        sa = tfa.adam_update(pa, _torch(grads), sa)
        sb = tfa.adam_update_plain(pb, _torch(grads), sb)
    assert kernels.counts()['adam_bf16'] == before    # no kernel for CPU
    for a, b in zip(param_leaves(pa) + param_leaves(sa.mu)
                    + param_leaves(sa.nu),
                    param_leaves(pb) + param_leaves(sb.mu)
                    + param_leaves(sb.nu)):
        assert torch.equal(a, b)
    assert param_leaves(sa.mu)[0].dtype == torch.bfloat16


def test_adam_init_moment_dtypes():
    params = _torch(_tree(3, 0.1))
    st = tfa.adam_init(params, LR, EPS, moment_dtype=torch.bfloat16)
    assert all(m.dtype == torch.bfloat16 and not m.any()
               for m in param_leaves(st.mu) + param_leaves(st.nu))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        tfa.adam_init(params, LR, EPS, moment_dtype=torch.float16)


def test_trainer_fused_bf16_step_matches_jax():
    kw = dict(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25,
              decay=0.9, quantizer='ema')
    jtr = JTrainer(JCfg(**kw), 0.01, 8, 37, adam_impl='fused_bf16')
    js = jtr.init_state(jax.random.PRNGKey(0))
    tcfg = tv.VqVaeConfig(**kw)
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), tcfg, 'cpu')
    assert param_leaves(ts.opt_state.mu)[0].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, size=(8, 6)).astype(np.float32)
    w = np.ones(8, np.float32)
    tr = Trainer(tcfg, 0.01, 8, 37, adam_impl='fused_bf16', device='cpu')
    ts2, _ = tr.train_step(ts, torch.from_numpy(y), torch.from_numpy(w))
    js2, _ = jax.jit(jtr.train_step)(js, jnp.asarray(y), jnp.asarray(w))
    js2 = jax.tree.map(np.asarray, js2)
    for got, ref in zip(param_leaves(ts2.params), jax.tree.leaves(
            js2.params)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    inner = js2.opt_state.inner_state[0]
    for name, mine, ref in (('mu', ts2.opt_state.mu, inner.mu),
                            ('nu', ts2.opt_state.nu, inner.nu)):
        for got, r in zip(param_leaves(mine), jax.tree.leaves(ref)):
            assert got.dtype == torch.bfloat16
            _within_a_bf16_ulp(got.float().numpy(), r.astype(np.float32),
                               name)
    # the port's state back in the JAX structure, bfloat16 included
    back = train_state_to_numpy(ts2, like=js2)
    assert jax.tree.structure(back) == jax.tree.structure(js2)
    assert all(np.asarray(a).dtype == np.asarray(b).dtype
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js2)))
    js3, _ = jax.jit(jtr.train_step)(jax.tree.map(jnp.asarray, back),
                                     jnp.asarray(y), jnp.asarray(w))
    assert int(js3.step) == 2


def test_trainer_fused_bf16_trains_on_the_cpu():
    cfg = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7)
    y = np.random.default_rng(2).integers(0, 2, size=(40, 6)).astype(
        np.float32)
    tr = Trainer(cfg, 0.01, 8, 40, adam_impl='fused_bf16', device='cpu')
    st, hist = tr.fit(tr.init_state(0), y, 3, seed=0)
    assert len(hist) == 3 and all(np.isfinite(list(m)).all() for m in hist)
    assert int(st.opt_state.count) == 15
    assert all(m.dtype == torch.bfloat16 for m in param_leaves(
        st.opt_state.mu) + param_leaves(st.opt_state.nu))
