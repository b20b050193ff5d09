"""The port's forward model (config, masks, init, encoder, codes) against
the JAX package's, with weights carried across by `params_from_jax`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pgmvae_tpu.models import vqvae as jv
from pgmvae_tpu_torch.convert import params_from_jax, params_to_numpy
from pgmvae_tpu_torch.models import vqvae as tv

CFG = dict(n_var=12, units=(10, 8, 6), dim=4, num_codes=9)


def _pair(seed=0, **over):
    kw = {**CFG, **over}
    jcfg, tcfg = jv.VqVaeConfig(**kw), tv.VqVaeConfig(**kw)
    p, cb = jv.init_model(jax.random.PRNGKey(seed), jcfg)
    pn = jax.tree.map(np.asarray, p)
    tp, tcb = params_from_jax(pn, None if cb is None else np.asarray(cb),
                              'cpu')
    return jcfg, tcfg, p, cb, tp, tcb


def _samples(n_rows, n_var, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n_rows, n_var)) < 0.35).astype(np.float32)


def test_config_fields_and_defaults_match_jax():
    assert tv.VqVaeConfig._fields == jv.VqVaeConfig._fields
    assert tv.VqVaeConfig._field_defaults == jv.VqVaeConfig._field_defaults
    for kw in (dict(CFG), dict(CFG, quantizer='naive', n_active=10)):
        j, t = jv.VqVaeConfig(**kw), tv.VqVaeConfig(**kw)
        assert t.effective_codes == j.effective_codes
        assert t.active_vars == j.active_vars
        assert tv._layer_dims(t) == jv._layer_dims(j)


@pytest.mark.parametrize('var_ids,n_active', [
    (None, None), ([3, 0, 7], None), (None, 9), ([1, 10, 2], 9)])
def test_loo_mask_matches_jax(var_ids, n_active):
    ref = jv.loo_mask(12, None if var_ids is None
                      else jnp.asarray(var_ids, jnp.int32),
                      n_active=n_active)
    got = tv.loo_mask(12, None if var_ids is None
                      else torch.tensor(var_ids), n_active=n_active,
                      device='cpu')
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('quantizer', ['ema', 'naive'])
@pytest.mark.parametrize('fan_mode', ['tf_stacked', 'per_network'])
def test_init_model_layout_matches_jax(quantizer, fan_mode):
    jcfg = jv.VqVaeConfig(**CFG, quantizer=quantizer, fan_mode=fan_mode)
    tcfg = tv.VqVaeConfig(**CFG, quantizer=quantizer, fan_mode=fan_mode)
    jp, jcb = jv.init_model(jax.random.PRNGKey(0), jcfg)
    tp, tcb = tv.init_model(torch.Generator().manual_seed(0), tcfg,
                            device='cpu')
    for stack in ('enc', 'dec'):
        assert len(tp[stack]) == len(jp[stack])
        for (tw, tb), (jw, jb) in zip(tp[stack], jp[stack]):
            assert tuple(tw.shape) == jw.shape and tuple(tb.shape) == jb.shape
            assert tw.dtype == torch.float32 and not bool(tb.any())
            # same distribution: both lie within the same uniform limit
            assert float(tw.abs().max()) <= float(jnp.abs(jw).max()) * 1.1
    if quantizer == 'naive':
        assert tcb is None and jcb is None
    else:
        assert tuple(tcb.shape) == jcb.shape


def test_params_round_trip_exact():
    _, _, p, cb, tp, tcb = _pair()
    back, back_cb = params_to_numpy(tp, tcb)
    for stack in ('enc', 'dec'):
        for (bw, bb), (jw, jb) in zip(back[stack], p[stack]):
            np.testing.assert_array_equal(bw, np.asarray(jw))
            np.testing.assert_array_equal(bb, np.asarray(jb))
    np.testing.assert_array_equal(back_cb, np.asarray(cb))


@pytest.mark.parametrize('activation', sorted(tv.ACTIVATIONS))
def test_activations_match_jax(activation):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        tv.activation_fn(activation)(torch.from_numpy(x)).numpy(),
        np.asarray(jv.activation_fn(activation)(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('first_layer', ['masked', 'rank1', 'auto'])
def test_encode_matches_jax(first_layer):
    jcfg, tcfg, p, cb, tp, tcb = _pair(seed=1)
    y = _samples(40, 12, seed=1)
    ref = np.asarray(jv.encode(p, jnp.asarray(y), first_layer=first_layer))
    got = tv.encode(tp, torch.from_numpy(y), first_layer=first_layer)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_encode_rank1_equals_masked_via_auto(monkeypatch):
    _, _, _, _, tp, _ = _pair(seed=2)
    y = torch.from_numpy(_samples(16, 12, seed=2))
    masked = tv.encode(tp, y, first_layer='masked')
    monkeypatch.setattr(tv, 'FIRST_LAYER_RANK1_BYTES', 0)
    auto = tv.encode(tp, y, first_layer='auto')
    np.testing.assert_allclose(auto.numpy(), masked.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('first_layer', ['masked', 'rank1'])
def test_encode_padded_n_active_matches_jax(first_layer):
    # n_var padded 12 -> 14: two inert networks, zero input columns
    jcfg, tcfg, p, cb, tp, tcb = _pair(seed=3, n_var=14, n_active=12)
    y = np.pad(_samples(24, 12, seed=3), ((0, 0), (0, 2)))
    ref = np.asarray(jv.encode(p, jnp.asarray(y), first_layer=first_layer))
    got = tv.encode(tp, torch.from_numpy(y), first_layer=first_layer)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_encode_var_ids_and_per_network_states_match_jax():
    _, _, p, cb, tp, tcb = _pair(seed=4)
    fts = np.array([5, 0, 11], np.int32)
    sp, _ = jv.gather_variables(p, cb, jnp.asarray(fts))
    tsp, _ = tv.gather_variables(tp, tcb, torch.from_numpy(fts))
    y2 = _samples(10, 12, seed=4)
    y3 = np.stack([_samples(10, 12, seed=s) for s in (5, 6, 7)])
    for y in (y2, y3):
        ref = np.asarray(jv.encode(sp, jnp.asarray(y), jnp.asarray(fts)))
        got = tv.encode(tsp, torch.from_numpy(y), torch.from_numpy(fts))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('over', [
    {}, {'first_layer': 'rank1'}, {'quantizer': 'naive'},
    {'n_var': 14, 'n_active': 12}, {'activation': 'gelu'}])
def test_encode_codes_bit_equal_to_jax(over):
    jcfg, tcfg, p, cb, tp, tcb = _pair(seed=5, **over)
    y = _samples(64, 12, seed=5)
    y = np.pad(y, ((0, 0), (0, jcfg.n_var - 12)))
    ref = np.asarray(jv.encode_codes(p, cb, jnp.asarray(y), jcfg))
    got = tv.encode_codes(tp, tcb, torch.from_numpy(y), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_variables_matches_jax():
    _, _, p, cb, tp, tcb = _pair(seed=6)
    fts = np.array([2, 2, 9], np.int32)
    jp, jcb = jv.gather_variables(p, cb, jnp.asarray(fts))
    tsp, tscb = tv.gather_variables(tp, tcb, torch.from_numpy(fts))
    back, back_cb = params_to_numpy(tsp, tscb)
    for stack in ('enc', 'dec'):
        for (bw, bb), (jw, jb) in zip(back[stack], jp[stack]):
            np.testing.assert_array_equal(bw, np.asarray(jw))
            np.testing.assert_array_equal(bb, np.asarray(jb))
    np.testing.assert_array_equal(back_cb, np.asarray(jcb))
