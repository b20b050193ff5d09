"""bf16 compute in the port against the JAX package's
(VqVaeConfig.compute_dtype='bf16'): the nearest-code search on bfloat16
operands, one bf16 train step from a carried-across state, bf16 training
with float32 masters, the rank-1 layer's exact-zero diagonal gradient in
bfloat16, and the command line's cd-bf16 result line."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgmvae_tpu.models import VqVaeConfig as JCfg
from pgmvae_tpu.ops.quantizer import vq_codes as jvq_codes
from pgmvae_tpu.train import Trainer as JTrainer
from pgmvae_tpu.utils.logging import run_identifier as jrun_identifier
from pgmvae_tpu_torch import run as trun
from pgmvae_tpu_torch.convert import train_state_from_jax
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_vq, kernels
from pgmvae_tpu_torch.ops import quantizer as tq
from pgmvae_tpu_torch.train import Trainer

KW = dict(n_var=6, units=(5, 4), dim=3, num_codes=7, cost=0.25, decay=0.9,
          quantizer='ema')
# the float32 rounding of a score of widened bfloat16 values: a code the
# plain version picks over the float64 argmin must be this close
F32_TIE = 1e-5
# the JAX kernel's |W_k|^2 is a bfloat16 sum of bfloat16 squares: its
# squares and its sum each round by up to 2^-9 relative, so each code's
# norm is off by up to about 2^-8 of it, and the pick may sit up to 2^-7
# max_k |W_k|^2 above the minimum
JAX_BF16_TIE = 2.0 ** -7
# the bf16 gradients of the two packages, each leaf's difference in norm
# against the norm of JAX's leaf: the packages cast and round at other
# places of the graph, a few bfloat16 roundings (2^-8 each) apart; on the
# batch of the step test the gap is at most 3.1% (mu). nu = (1 - b2) g^2
# doubles the relative error, so it is held at twice this
BF16_GRAD = 8e-2


def _bf16(x: np.ndarray):
    """The same bfloat16 values on both sides: a torch tensor and a JAX
    array, from float32 numpy rounded once by torch."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _gaps(z, w, codes):
    """float64 distance of each row's pick above the row's minimum, and the
    scales |z|^2 + d_min and max_k |W_k|^2 of each row."""
    z, w = z.double(), w.double()
    dist = ((z[:, :, :, None] - w[:, None]) ** 2).sum(2)            # [n,B,K]
    dmin = dist.min(2).values
    pick = dist.gather(2, codes.long()[:, :, None])[:, :, 0]
    w2 = (w * w).sum(1).max(1).values[:, None].expand_as(dmin)
    return pick - dmin, torch.maximum(dmin, (z * z).sum(2)), w2


@pytest.mark.parametrize('shape', [(4, 33, 6, 70), (3, 64, 10, 512),
                                   (8, 16, 20, 50),
                                   # the bfloat16 kernel's ragged edges
                                   # (chip_smoke.BF16_RAGGED): D = 5, 33,
                                   # K = 15, codes across its tile edge
                                   (5, 37, 5, 64), (3, 29, 33, 96),
                                   (13, 100, 20, 15), (2, 40, 8, 130)])
def test_bf16_codes_are_the_widened_argmin_and_near_jax(shape):
    n, b, d, k = shape
    rng = np.random.default_rng(sum(shape))
    z, zj = _bf16(rng.standard_normal((n, b, d)).astype(np.float32))
    w, wj = _bf16(rng.standard_normal((n, d, k)).astype(np.float32))
    got = cuda_vq.vq_codes_fused(z, w)
    launches = kernels.counts()
    assert launches['vq_argmin'] == launches['vq_argmin_bf16'] == 0
    # the plain version is the float32 arithmetic on the widened values
    np.testing.assert_array_equal(
        got.numpy(), cuda_vq.vq_codes_plain(z.float(), w.float()).numpy())
    gap, scale, _ = _gaps(z.float(), w.float(), got)
    assert bool((gap <= F32_TIE * scale).all()), float(gap.max())
    # JAX's Pallas kernel on the same bfloat16 operands
    ref = torch.from_numpy(np.asarray(
        jvq_codes(zj, wj, impl='pallas_interpret')).astype(np.int32))
    diff = got != ref
    assert float(diff.float().mean()) <= 0.01, int(diff.sum())
    gap_j, scale_j, w2 = _gaps(z.float(), w.float(), ref)
    assert bool((gap_j[diff] <= JAX_BF16_TIE * w2[diff]
                 + F32_TIE * scale_j[diff]).all())


def test_bf16_vq_forward_follows_jax_promotion():
    """The losses' squares are bfloat16 and the float32 weights promote
    their sums to float32; the straight-through output stays bfloat16."""
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((3, 8, 4)).astype(
        np.float32)).bfloat16().requires_grad_()
    cb = torch.from_numpy(rng.standard_normal((3, 4, 5)).astype(
        np.float32)).bfloat16()
    w = torch.ones(8)
    out = tq.vq_forward(z, cb, w)
    assert out.output.dtype == torch.bfloat16
    assert out.e_loss.dtype == out.q_loss.dtype == torch.float32
    out.e_loss.backward()
    assert z.grad.dtype == torch.bfloat16
    ref = ((cb.float().transpose(1, 2).gather(
        1, out.indices.long()[:, :, None].expand(-1, -1, 4))
        - z.float()) ** 2).mean()
    np.testing.assert_allclose(float(out.e_loss.detach()),
                               float(ref.detach()),
                               rtol=2e-2)


def test_bf16_train_step_matches_jax():
    """One bf16 step from a carried-across JAX state on the same batch. The
    two packages round to bfloat16 at other places, so: loss within 2e-2
    relative; params within 2 lr absolute (a bfloat16 sign flip of a
    near-zero gradient moves Adam's first step by 2 lr); masters float32.
    Adam's first step bounds every param move by lr whatever the gradient,
    so the gradient itself is held through the moments it leaves, mu =
    (1 - b1) g and nu = (1 - b2) g^2: each leaf within BF16_GRAD (nu: twice
    that) in norm, relative to JAX's leaf."""
    lr = 0.01
    jcfg = JCfg(**KW, compute_dtype='bf16', vq_impl='pallas_interpret')
    tcfg = tv.VqVaeConfig(**KW, compute_dtype='bf16')
    jtr = JTrainer(jcfg, lr, 8, 37)
    js = jtr.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    y = rng.integers(0, 2, size=(8, 6)).astype(np.float32)
    w = np.ones(8, np.float32)
    w[5] = 0.0
    tr = Trainer(tcfg, lr, 8, 37, device='cpu')
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), tcfg, 'cpu')
    ts2, tm = tr.train_step(ts, torch.from_numpy(y), torch.from_numpy(w))
    js2, jm = jax.jit(jtr.train_step)(js, jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(float(tm[0]), float(jm.loss), rtol=2e-2)
    for got, ref in zip(tv.param_leaves(ts2.params),
                        jax.tree.leaves(js2.params)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2 * lr)
    adam = js2.opt_state.inner_state[0]
    for moment, ref_tree, tol in (('mu', adam.mu, BF16_GRAD),
                                  ('nu', adam.nu, 2 * BF16_GRAD)):
        for got, ref in zip(tv.param_leaves(getattr(ts2.opt_state, moment)),
                            jax.tree.leaves(ref_tree)):
            ref = np.asarray(ref)
            assert got.dtype == torch.float32 and np.linalg.norm(ref) > 0
            gap = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
            assert gap <= tol, (moment, ref.shape, gap)
    assert all(t.dtype == torch.float32 for t in ts2.ema[:3])
    np.testing.assert_allclose(ts2.ema.codebook.numpy(),
                               np.asarray(js2.ema.codebook), atol=2e-2)


@pytest.mark.parametrize('quantizer', ['ema', 'vq'])
def test_bf16_trains_and_masters_stay_f32(quantizer):
    """The port of the JAX package's test of the same name: bf16 training
    keeps float32 masters, moments and EMA state, and tracks the float32
    run within the JAX test's sanity band (10% of the final loss)."""
    cfg32 = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7,
                           cost=0.25, decay=0.9, quantizer=quantizer)
    cfg16 = cfg32._replace(compute_dtype='bf16')
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, size=(64, 6)).astype(np.float32)
    losses = {}
    for cfg in (cfg32, cfg16):
        tr = Trainer(cfg, 0.01, 16, 64, device='cpu')
        state, ms = tr.fit(tr.init_state(0), y, epochs=8, seed=1)
        leaves = (tv.param_leaves(state.params)
                  + tv.param_leaves(state.opt_state.mu)
                  + tv.param_leaves(state.opt_state.nu))
        assert all(t.dtype == torch.float32 for t in leaves)
        if quantizer == 'ema':
            assert state.ema.codebook.dtype == torch.float32
            assert state.ema.counts.dtype == torch.float32
        assert all(np.isfinite(m.loss) for m in ms)
        losses[cfg.compute_dtype] = ms[-1].loss
    assert abs(losses['bf16'] - losses['f32']) < 0.1 * abs(
        losses['f32']) + 5e-3, losses


def test_bf16_rank1_weight_grad_diagonal_is_exactly_zero():
    cfg = tv.VqVaeConfig(n_var=6, units=(5, 4), dim=3, num_codes=7)
    params, _ = tv.init_model(torch.Generator().manual_seed(0), cfg,
                              device='cpu')
    w0 = params['enc'][0][0].bfloat16().requires_grad_()
    y = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, (9, 6)).astype(np.float32)).bfloat16()
    out = tv._Rank1Linear.apply(w0, y)
    assert out.dtype == torch.bfloat16
    torch.sum(out * torch.linspace(-1, 1, out.numel()).view(
        out.shape).bfloat16()).backward()
    assert w0.grad.dtype == torch.bfloat16
    diag = torch.diagonal(w0.grad, dim1=0, dim2=1)
    assert torch.equal(diag, torch.zeros_like(diag))
    assert float(w0.grad.abs().sum()) > 0


def _write_splits(root, rows=(300, 100, 100), seed=0):
    rng = np.random.default_rng(seed)
    rate = rng.random(16)
    for split, n in zip(('train', 'valid', 'test'), rows):
        y = (rng.random((n, 16)) < rate).astype(np.uint8)
        with open(os.path.join(root, f'nltcs.{split}.data'), 'w') as f:
            f.write('\n'.join(','.join(map(str, r)) for r in y) + '\n')


def test_cli_compute_dtype_bf16_writes_a_cd_line(tmp_path, monkeypatch):
    _write_splits(tmp_path)
    monkeypatch.chdir(tmp_path)
    flags = ['-n', 'nltcs', '-k', '8', '-d', '4', '-b', '64', '-e', '2',
             '-r', '0.01', '-m', '-s', '1']
    assert trun.main(flags + ['--compute-dtype', 'bf16', '--device', '-1',
                              '--data-dir', str(tmp_path)]) == 0
    line = (tmp_path / 'result.txt').read_text().splitlines()[-1]
    ident, rest = line.split(' ', 1)
    assert ident == jrun_identifier('nltcs', 8, 4, 64, 2, 0.01, 0.25, True,
                                    0.99, 1, compute_dtype='bf16')
    assert ident.endswith('_cd-bf16')
    plls = [float(kv.split(':')[1]) for kv in rest.split()[:3]]
    assert all(np.isfinite(v) and v < 0 for v in plls), plls
