"""The port's training ops (straight-through quantizer, code statistics, EMA
update, dead-code restarts, naive quantizer) and its training forward and
gradients against the JAX package's, on the same numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu import train as jtrain
from pgmvae_tpu.models import vqvae as jv
from pgmvae_tpu.ops import quantizer as jq
from pgmvae_tpu_torch.convert import params_from_jax
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_recon
from pgmvae_tpu_torch.ops import quantizer as tq


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _weights(b, zero_rows=()):
    w = np.ones(b, np.float32)
    w[list(zero_rows)] = 0.0
    return w


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# ----------------------------------------------------------------- ops --

@pytest.mark.parametrize('zero_rows,n_active', [
    ((), None), ((3, 8), None), ((0,), 4)])
def test_vq_forward_and_gradients_match_jax(zero_rows, n_active):
    n, b, d, k = 5, 9, 4, 11
    z, cb, r = _arrays(0, (n, b, d), (n, d, k), (n, b, d))
    w = None if not zero_rows and n_active is None else _weights(b, zero_rows)

    def jf(z, cb):
        out = jq.vq_forward(z, cb, _j(w), n_active=n_active)
        return (jnp.sum(out.output * r) + 0.7 * out.e_loss
                + 1.3 * out.q_loss), out

    (_, jout), (jgz, jgc) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(z), jnp.asarray(cb))
    tz = torch.from_numpy(z).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    tout = tq.vq_forward(tz, tcb, _t(w), n_active=n_active)
    (torch.sum(tout.output * _t(r)) + 0.7 * tout.e_loss
     + 1.3 * tout.q_loss).backward()

    np.testing.assert_array_equal(tout.indices.numpy(),
                                  np.asarray(jout.indices))
    for got, ref in ((tout.output, jout.output), (tout.e_loss, jout.e_loss),
                     (tout.q_loss, jout.q_loss), (tz.grad, jgz),
                     (tcb.grad, jgc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('weighted', [False, True])
def test_code_stats_match_jax(weighted):
    n, b, d, k = 4, 13, 3, 7
    (z,) = _arrays(1, (n, b, d))
    idx = np.random.default_rng(1).integers(0, k, (n, b)).astype(np.int32)
    w = _weights(b, (2, 5)) if weighted else None
    jc, jdw = jq.code_stats(jnp.asarray(z), jnp.asarray(idx), k, _j(w))
    tc, tdw = tq.code_stats(_t(z), _t(idx), k, _t(w))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('zero_debias', [True, False])
def test_five_ema_updates_match_jax(zero_debias):
    n, d, k = 3, 4, 6
    (cb,) = _arrays(2, (n, d, k))
    js = jq.ema_init(jnp.asarray(cb), zero_debias)
    ts = tq.ema_init(_t(cb), zero_debias)
    rng = np.random.default_rng(2)
    for _ in range(5):
        counts = rng.integers(0, 5, (n, k)).astype(np.float32)
        dw = rng.standard_normal((n, d, k)).astype(np.float32)
        js = jq.ema_update(js, jnp.asarray(counts), jnp.asarray(dw), 0.9,
                           1e-5, zero_debias)
        ts = tq.ema_update(ts, _t(counts), _t(dw), 0.9, 1e-5, zero_debias)
    for f in ('codebook', 'counts', 'dw'):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   err_msg=f)
    assert int(ts.step) == int(js.step) == 5
    assert ts.step.dtype == torch.int32


@pytest.mark.parametrize('zero_debias,step', [(True, 0), (True, 3),
                                              (False, 2)])
def test_apply_restart_with_jax_drawn_rows_is_exact(zero_debias, step):
    n, b, d, k = 4, 10, 3, 6
    z, cb, dw = _arrays(3, (n, b, d), (n, d, k), (n, d, k))
    counts = np.random.default_rng(3).random((n, k)).astype(np.float32)
    w = _weights(b, (1, 4, 9))
    js = jq.EmaState(jnp.asarray(cb), jnp.asarray(counts), jnp.asarray(dw),
                     jnp.asarray(step, jnp.int32))
    ts = tq.EmaState(_t(cb), _t(counts), _t(dw),
                     torch.tensor(step, dtype=torch.int32))
    key = jax.random.PRNGKey(7)
    ref = jq.restart_dead_codes(js, jnp.asarray(z), key, 0.5, 0.9,
                                zero_debias, weights=jnp.asarray(w))
    # the rows restart_dead_codes draws, drawn the same way
    ridx = jax.random.categorical(
        key, jnp.where(jnp.asarray(w) > 0, 0.0, -jnp.inf), shape=(n, k))
    assert not np.isin(np.asarray(ridx), [1, 4, 9]).any()
    got = tq._apply_restart(ts, _t(z), _t(np.asarray(ridx)), 0.5, 0.9,
                            zero_debias)
    assert not np.array_equal(got.codebook.numpy(), cb)   # some restarted
    for f in ('codebook', 'counts', 'dw', 'step'):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_restart_draws_only_rows_with_weight():
    n, b, d, k = 6, 12, 2, 40
    z, cb = _arrays(4, (n, b, d), (n, d, k))
    z[:, 3] = 100.0                     # weight-0 rows are unmistakable
    z[:, 7] = 100.0
    st = tq.EmaState(_t(cb), torch.zeros((n, k)), torch.zeros((n, d, k)),
                     torch.tensor(2, dtype=torch.int32))
    out = tq.restart_dead_codes(st, _t(z), torch.Generator().manual_seed(0),
                                1.0, 0.9, weights=_t(_weights(b, (3, 7))))
    picked = out.codebook.numpy()
    assert np.abs(picked).max() < 100.0                  # every code moved
    rows = {tuple(r) for v in range(n) for r in z[v]}
    assert all(tuple(picked[v, :, c]) in rows
               for v in range(n) for c in range(k))
    # unweighted draws spread over every row
    out = tq.restart_dead_codes(st, _t(z), torch.Generator().manual_seed(0),
                                1.0, 0.9)
    assert (out.codebook.numpy() == 100.0).any()


def test_naive_forward_and_gradient_match_jax():
    (z,) = _arrays(5, (4, 8, 3))
    z = z * 0.5 + 0.5
    w = _weights(8, (6,))

    def jf(z):
        out = jq.naive_forward(z, jnp.asarray(w))
        return jnp.sum(out.output * 0.3) + out.e_loss, out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(z))
    tz = _t(z).requires_grad_()
    tout = tq.naive_forward(tz, _t(w))
    (torch.sum(tout.output * 0.3) + tout.e_loss).backward()
    np.testing.assert_array_equal(tout.output.detach().numpy(),
                                  np.asarray(jout.output))
    np.testing.assert_allclose(tout.e_loss.item(), float(jout.e_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


# --------------------------------------------------------------- model --

CFG = dict(n_var=12, units=(10, 8), dim=4, num_codes=9, cost=0.3)


def _model(seed, **over):
    kw = {**CFG, **over}
    jcfg, tcfg = jv.VqVaeConfig(**kw), tv.VqVaeConfig(**kw)
    p, cb = jv.init_model(jax.random.PRNGKey(seed), jcfg)
    if jcfg.quantizer == 'vq':
        p['codebook'] = cb
    pn = jax.tree.map(np.asarray, p)
    tp, tcb = params_from_jax(pn, None if cb is None else np.asarray(cb),
                              'cpu')
    return jcfg, tcfg, p, cb, tp, tcb


def _batch(cfg, b=10, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.random((b, cfg.active_vars)) < 0.4).astype(np.float32)
    return np.pad(y, ((0, 0), (0, cfg.n_var - cfg.active_vars)))


@pytest.mark.parametrize('over', [
    {}, {'quantizer': 'vq'}, {'quantizer': 'naive'}, {'first_layer': 'rank1'},
    {'n_var': 14, 'n_active': 12}])
def test_apply_model_matches_jax(over):
    jcfg, tcfg, p, cb, tp, tcb = _model(0, **over)
    y, w = _batch(jcfg), _weights(10, (4,))
    ref = jv.apply_model(p, cb, jnp.asarray(y), jcfg, jnp.asarray(w))
    got = tv.apply_model(tp, tcb, _t(y), tcfg, _t(w))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    for f in ('recon', 'z', 'e_loss', 'q_loss'):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)


def _jax_loss(cfg, y, w):
    mask = jv.loo_mask(cfg.n_var, None, jnp.float32, n_active=cfg.active_vars)

    def loss(params, codebook):
        cbk = params['codebook'] if cfg.quantizer == 'vq' else codebook
        out = jv.apply_model(params, cbk, y, cfg, weights=w)
        mse = jtrain._masked_recon_mean((out.recon - y[None]) ** 2, w, mask,
                                        cfg.active_vars)
        aux = cfg.cost * out.e_loss
        if cfg.quantizer == 'vq':
            aux = aux + out.q_loss
        return mse + aux + cfg.l2_reg * jv.l2_penalty(params)
    return loss


def _torch_loss(cfg, y, w):
    mask = tv.loo_mask(cfg.n_var, None, n_active=cfg.active_vars,
                       device='cpu')

    def loss(params, codebook):
        cbk = params['codebook'] if cfg.quantizer == 'vq' else codebook
        out = tv.apply_model(params, cbk, y, cfg, weights=w)
        mse = cuda_recon.masked_recon_mean((out.recon - y[None]) ** 2, w,
                                           mask, cfg.active_vars)
        aux = cfg.cost * out.e_loss
        if cfg.quantizer == 'vq':
            aux = aux + out.q_loss
        return mse + aux + cfg.l2_reg * tv.l2_penalty(params)
    return loss


def _torch_grads(tcfg, tp, tcb, y, w):
    leaves = [x.clone().requires_grad_() for x in tv.param_leaves(tp)]
    loss = _torch_loss(tcfg, _t(y), _t(w))(
        tv.params_from_leaves(tp, leaves), tcb)
    return loss, tv.params_from_leaves(
        tp, torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize('over', [
    {}, {'first_layer': 'rank1'}, {'quantizer': 'vq', 'l2_reg': 0.01},
    {'quantizer': 'naive'},
    {'n_var': 14, 'n_active': 12},
    {'n_var': 14, 'n_active': 12, 'first_layer': 'rank1'}])
def test_training_loss_gradients_match_jax(over):
    jcfg, tcfg, p, cb, tp, tcb = _model(1, **over)
    y, w = _batch(jcfg, seed=1), _weights(10, (2, 7))
    jloss, jg = jax.value_and_grad(_jax_loss(jcfg, jnp.asarray(y),
                                             jnp.asarray(w)))(p, cb)
    tloss, tg = _torch_grads(tcfg, tp, tcb, y, w)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    tleaves = tv.param_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for i, (got, ref) in enumerate(zip(tleaves, jleaves)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6, err_msg=f'leaf {i}')


@pytest.mark.parametrize('first_layer', ['masked', 'rank1'])
def test_inert_weights_get_exactly_zero_gradient(first_layer):
    _, tcfg, _, _, tp, tcb = _model(2, first_layer=first_layer)
    y, w = _batch(tcfg, b=8, seed=2), _weights(8)
    _, g = _torch_grads(tcfg, tp, tcb, y, w)
    g_enc0 = g['enc'][0][0].numpy()                  # [n, n, u0]
    g_dec = g['dec'][-1][0].numpy()                  # [n, u_last, n]
    for v in range(tcfg.n_var):
        np.testing.assert_array_equal(g_enc0[v, v, :], 0.0)
        np.testing.assert_array_equal(g_dec[v, :, v], 0.0)
    assert np.abs(g_enc0).max() > 0


def test_l2_penalty_matches_jax():
    _, _, p, _, tp, _ = _model(3, quantizer='vq')
    np.testing.assert_allclose(tv.l2_penalty(tp).item(),
                               float(jv.l2_penalty(p)), rtol=1e-6)
