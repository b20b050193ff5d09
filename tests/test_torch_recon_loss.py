"""The reconstruction tail's kernel pair (`ops/cuda_recon.py`,
`csrc/recon_loss.cu`) on the CPU: `recon_loss`'s plain forward and
autograd's backward against an independent float64 formula (and, in
bfloat16, against the composition the training step differentiated before
it), a CPU train step through it against one through that composition, the
launch counter,
what the wrapper refuses before it launches anything, and the launch plans
at the main paths' shapes. The kernels themselves are held to their plain
versions on the card (chip_smoke.py, phase kernel_recon)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch import train as ttrain
from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_recon, kernels

SRC = Path(cuda_recon.__file__).resolve().parent / 'csrc' / 'recon_loss.cu'


@pytest.fixture
def no_launch(monkeypatch):
    """Building the kernels fails the test: nothing may reach a launch."""
    def build():
        raise AssertionError('the kernels were built')
    monkeypatch.setattr(cuda_recon, 'build', build)
    monkeypatch.setattr(kernels, '_COUNTS',
                        dict.fromkeys(kernels.counts(), 0))


# (seeds, F, B, N, lo, n_active, global wsum, padded rows)
CASES = {
    'unpacked': (None, 11, 7, 11, 0, 11, None, ()),
    'packed S=4': (4, 4 * 9, 6, 9, 0, 9, None, ()),
    'a shard from lo=3, global wsum': (None, 4, 7, 11, 3, 11, 12.0, ()),
    'n_active < n_var': (None, 10, 5, 10, 0, 7, None, ()),
    'packed, n_active < n_var': (3, 3 * 8, 5, 8, 0, 6, None, ()),
    'a shard past n_active': (None, 4, 6, 12, 8, 10, 9.0, ()),
    'weight-0 rows': (None, 9, 8, 9, 0, 9, None, (2, 7)),
    'packed, weight-0 rows': (2, 2 * 7, 6, 7, 0, 7, None, (0, 5)),
}


def _inputs(case, seed=0, dtype=torch.float32):
    seeds, f, b, n, lo, na, wsum, pad = CASES[case]
    rng = np.random.default_rng(seed)
    s = seeds or 1
    x = torch.from_numpy(rng.normal(0.0, 2.0, (f, b, n)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (s, b, n)).astype(np.float32))
    w = torch.ones(b)
    w[list(pad)] = 0.0
    g = torch.from_numpy(rng.uniform(0.5, 2.0, s).astype(np.float32))
    return (x.to(dtype), y if seeds else y[0], w,
            None if wsum is None else torch.tensor(wsum), g if seeds else
            g[0], seeds, lo, na)


def _float64(x, y, w, wsum, g, seeds, lo, na):
    """mse, mae [S] and the mse's gradient from the definitions, in
    float64 with an explicit mask: network f of seed s is variable
    lo + f mod fps; its own column, columns past n_active and networks past
    it are out."""
    x = x.double().numpy()
    f, b, n = x.shape
    s = seeds or 1
    fps = f // s
    y = y.double().numpy().reshape(s, b, n)
    w = w.double().numpy()
    m = np.zeros((fps, n))
    for i in range(fps):
        for c in range(n):
            m[i, c] = float(c != lo + i and c < na and lo + i < na)
    d = na * (na - 1) * max(w.sum() if wsum is None else float(wsum), 1.0)
    r = 1.0 / (1.0 + np.exp(-x.reshape(s, fps, b, n)))
    e = r - y[:, None]
    k = m[None, :, None, :] * w[None, None, :, None]
    mse = np.sum(k * e * e, axis=(1, 2, 3)) / d
    mae = np.sum(k * np.abs(e), axis=(1, 2, 3)) / d
    gs = np.asarray(g, dtype=np.float64).reshape(-1, 1, 1, 1)
    grad = gs * 2.0 * e * k / d * r * (1.0 - r)
    return mse, mae, grad.reshape(f, b, n)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_the_plain_function_matches_its_definition(no_launch, case, dtype):
    """float32: the CPU path's mse, mae and gradient against float64
    (float32 sums of at most a few thousand terms, and a gradient of six
    rounded products: 1e-6 relative, the gradient's elements within 1e-6
    of its largest). bfloat16: bit-equal to autograd through the
    composition the step differentiated before the kernel (the sigmoid,
    the bfloat16 error and square, the float32 mask and weights, the MAE
    against float32 y)."""
    dt = getattr(torch, dtype)
    x, y, w, wsum, g, seeds, lo, na = _inputs(case, dtype=dt)
    x.requires_grad_()
    mse, mae = cuda_recon.recon_loss(x, y, w, seeds, lo, na, wsum)
    assert not mae.requires_grad and mse.shape == (() if seeds is None
                                                   else (seeds,))
    grad, = torch.autograd.grad(mse, x, g)
    assert grad.dtype == dt and kernels.counts()['recon'] == 0
    if dt == torch.float32:
        want = _float64(x.detach(), y, w, wsum, g, seeds, lo, na)
        for got, ref in zip((mse, mae), want):
            np.testing.assert_allclose(
                np.atleast_1d(got.detach().double().numpy()), ref, rtol=1e-6)
        np.testing.assert_allclose(grad.double().numpy(), want[2], rtol=0,
                                   atol=1e-6 * np.abs(want[2]).max())
        return
    x2 = x.detach().clone().requires_grad_()
    recon = torch.sigmoid(x2)
    mask = tv.loo_mask(x.shape[-1], torch.arange(lo, lo + x.shape[0]
                                                 // (seeds or 1)),
                       torch.float32, n_active=na)
    ref = cuda_recon.masked_recon_mean(
        cuda_recon.recon_error(recon, y.to(dt), seeds) ** 2, w, mask, na,
        wsum)
    ref_mae = cuda_recon.masked_recon_mean(
        torch.abs(cuda_recon.recon_error(recon.detach(), y, seeds)), w, mask,
        na, wsum)
    ref_grad, = torch.autograd.grad(ref, x2, g)
    assert torch.equal(mse, ref) and torch.equal(mae, ref_mae)
    assert torch.equal(grad, ref_grad)


STEP_CFGS = {
    'f32': tv.VqVaeConfig(n_var=9, units=(8, 6), dim=4, num_codes=5,
                          decay=0.9, dead_code_threshold=0.5),
    'bf16': tv.VqVaeConfig(n_var=9, units=(8, 6), dim=4, num_codes=5,
                           decay=0.9, compute_dtype='bf16'),
    'padded n_active': tv.VqVaeConfig(n_var=10, units=(8, 6), dim=4,
                                      num_codes=5, n_active=7),
    'vq quantizer': tv.VqVaeConfig(n_var=9, units=(8,), dim=3, num_codes=6,
                                   quantizer='vq'),
}


def _today(logits, y, w, seeds=None, lo=0, n_active=None, wsum=None):
    """The step's loss before the kernel pair: autograd through the plain
    composition."""
    return cuda_recon.recon_loss_plain(logits, y, w, seeds, lo, n_active,
                                       wsum)


@pytest.mark.parametrize('packed', [False, True])
@pytest.mark.parametrize('name', sorted(STEP_CFGS))
def test_a_cpu_step_is_the_step_before_the_kernel(no_launch, monkeypatch,
                                                   name, packed):
    """`Trainer._step` through `recon_loss` gives the loss, mse, mae and
    gradients (so the new params and moments) of the same step through
    autograd over the plain composition, bit for bit, with a ragged
    batch."""
    cfg = STEP_CFGS[name]
    rng = np.random.default_rng(3)
    b = 6
    w = torch.ones(b)
    w[4:] = 0.0
    tr = ttrain.Trainer(cfg, 1e-2, b, 40, device='cpu', graphs=False)
    if packed:
        start = tr.init_states_packed([1, 2])
        y = torch.from_numpy(rng.integers(0, 2, (2, b, cfg.n_var))
                             .astype(np.float32))
    else:
        start = tr.init_state(1)
        y = torch.from_numpy(rng.integers(0, 2, (b, cfg.n_var))
                             .astype(np.float32))

    def step():
        state = ttrain.copy_state(start)
        gens = [torch.Generator().manual_seed(7)]
        if packed:
            return tr.train_step_packed(state, y, w, gens * 2)
        return tr.train_step(state, y, w, gens[0])
    got_state, got = step()
    monkeypatch.setattr(cuda_recon, 'recon_loss', _today)
    ref_state, ref = step()
    assert torch.equal(got, ref)
    flat = []
    ttrain._map_state(lambda a, b: flat.append(torch.equal(a, b)),
                      got_state, ref_state)
    assert all(flat) and len(flat) > 10


def test_the_counter_is_registered_and_the_cpu_launches_nothing(no_launch):
    assert kernels.counts()['recon'] == 0
    x, y, w, wsum, g, seeds, lo, na = _inputs('unpacked')
    x.requires_grad_()
    mse, _ = cuda_recon.recon_loss(x, y, w, seeds, lo, na, wsum)
    mse.backward()
    assert kernels.counts()['recon'] == 0


# ----------------------------------------------------------- refusals --

def _bad(case):
    x, y, w, wsum, g, seeds, lo, na = _inputs('packed S=4')
    args = dict(logits=x, y=y, w=w, seeds=seeds, lo=lo, n_active=na,
                wsum=wsum)
    if case == 'logits 2-D':
        args['logits'] = x[0]
    elif case == 'y of 3 seeds':
        args['y'] = y[:3]
    elif case == 'y [S, B, N+1]':
        args['y'] = torch.zeros(4, y.shape[1], y.shape[2] + 1)
    elif case == 'F not a multiple of S':
        args['logits'] = x[:-1]
    elif case == 'weights [B+1]':
        args['w'] = torch.ones(w.shape[0] + 1)
    elif case == 'wsum of two values':
        args['wsum'] = torch.ones(2)
    elif case == 'n_active past N':
        args['n_active'] = x.shape[-1] + 1
    elif case == 'networks past N':
        args['lo'] = 1
    elif case == 'logits not contiguous':
        args['logits'] = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == 'on the meta device':
        args = {k: v.to('meta') if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
    return args


@pytest.mark.parametrize('case', [
    'logits 2-D', 'y of 3 seeds', 'y [S, B, N+1]', 'F not a multiple of S',
    'weights [B+1]', 'wsum of two values', 'n_active past N',
    'networks past N', 'logits not contiguous', 'on the meta device'])
def test_the_wrapper_refuses_before_any_launch(no_launch, case):
    with pytest.raises(ValueError):
        cuda_recon.recon_loss(**_bad(case))
    assert kernels.counts()['recon'] == 0


# --------------------------------------------------------------- plans --

# (F, B, N, S): bbc's quality recipe and its batch 250, a mesh_bbc rank's
# networks, kdd's train batch alone and packed (S=4), ad at batch 250,
# nltcs's headline, stream_big's batch, and an odd width
MAIN_SHAPES = [(1058, 25, 1058, 1), (1058, 250, 1058, 1),
               (265, 125, 1060, 1), (64, 32, 64, 1), (256, 32, 64, 4),
               (1556, 250, 1556, 1), (16, 128, 16, 1), (64, 256, 64, 1),
               (9, 5, 9, 1)]


@pytest.mark.parametrize('shape', MAIN_SHAPES)
def test_plan_covers_the_shape(shape):
    """Every row of a seed has one warp, and no block is empty."""
    f, b, n, s = shape
    p = cuda_recon.plan(f, b, n, s)
    rows = f // s * b
    per_block = p.threads // 32 * p.rpw
    assert p.bps * per_block >= rows > (p.bps - 1) * per_block
    assert p.threads == cuda_recon.THREADS and p.rpw >= 1


def test_plan_of_the_two_bbc_cells():
    """A warp a row at batch 25; at batch 250 eight rows a warp keep the
    grid to four waves of resident warps."""
    assert cuda_recon.plan(1058, 25, 1058) == (256, 1, 3307)
    assert cuda_recon.plan(1058, 250, 1058) == (256, 8, 4133)
    assert cuda_recon.plan(256, 32, 64, 4) == (256, 1, 256)


@pytest.mark.parametrize('shape', [(0, 4, 4, 1), (9, 4, 4, 2),
                                   (2 ** 20, 2 ** 11, 4, 1),
                                   (65536, 1, 4, 65536)])
def test_plan_refuses_what_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        cuda_recon.plan(*shape)


def test_plan_constants_and_the_c_signatures_match_the_source():
    """The block size is the kernels', and the ctypes argument lists have
    the C entry points' lengths."""
    src = SRC.read_text()
    assert int(re.search(r'constexpr int MAX_THREADS = (\d+);', src)[1]) \
        == cuda_recon.THREADS

    def n_args(name):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)[1]
        return len(sig.split(','))
    assert n_args('recon_loss_fwd') == 20
    assert n_args('recon_loss_bwd') == 18
