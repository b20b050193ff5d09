"""The masked first layer's kernel wrapper (`ops/cuda_first_layer.py`,
`csrc/first_layer.cu`) on the CPU: its plain version against the masked
input and `baddbmm` that `encode` ran before it (bit for bit) and against
the layer's definition in float64, its autograd Function's gradients
(the forward's kernel stood in for by the plain version) against
autograd through the plain version, which calls of `encode` take it, the
launch counter, what the wrapper refuses before it launches anything, and
the tile plans. The kernel itself is held to its plain version on the card
(chip_smoke.py, phase kernel_first_layer)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.ops import cuda_first_layer as cfl
from pgmvae_tpu_torch.ops import kernels

SRC = Path(cfl.__file__).resolve().parent / 'csrc' / 'first_layer.cu'


@pytest.fixture
def no_launch(monkeypatch):
    """Building the kernel fails the test: nothing may reach a launch."""
    def build():
        raise AssertionError('the kernel was built')
    monkeypatch.setattr(cfl, 'build', build)
    monkeypatch.setattr(kernels, '_COUNTS',
                        dict.fromkeys(kernels.counts(), 0))


# (seeds, F, B, N, O, lo, n_active)
CASES = {
    'one network': (None, 1, 5, 7, 4, 3, 7),
    'several networks': (None, 9, 6, 9, 5, 0, 9),
    'packed seeds': (3, 3 * 6, 4, 6, 5, 0, 6),
    'a shard from lo=5': (None, 4, 7, 11, 3, 5, 11),
    'n_active < n_var': (None, 10, 5, 10, 4, 0, 7),
}


def _inputs(case, seed=0):
    seeds, f, b, n, o, lo, na = CASES[case]
    rng = np.random.default_rng(seed)
    s = seeds or 1
    w0 = torch.from_numpy(rng.normal(0.0, 0.5, (f, n, o)).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(0.0, 0.5, (f, 1, o)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 2, (s, b, n)).astype(np.float32))
    return w0, b0, (y if seeds else y[0]), seeds, lo, na


def _masked(w0, b0, y, seeds, lo, na):
    """The masked input and `baddbmm` as `encode` computed them before the
    kernel, `loo_mask`'s padding included."""
    n = y.shape[-1]
    f = w0.shape[0] // (seeds or 1)
    mask = tv.loo_mask(n, torch.arange(lo, lo + f), y.dtype,
                       n_active=None if na == n else na)
    x = (y[:, None] * mask).flatten(0, 1) if seeds else y[None] * mask
    return torch.baddbmm(b0, x, w0)


def _float64(w0, b0, y, seeds, lo, na):
    """out[s F + v, r, o] = b + sum over k != lo + v, k < n_active of
    y[s, r, k] w[s F + v, k, o]; a network past n_active gives its bias."""
    s = seeds or 1
    w = w0.double().numpy()
    sf, n, o = w.shape
    f = sf // s
    yy = y.double().numpy().reshape(s, -1, n)
    out = np.empty((sf, yy.shape[1], o))
    for i in range(sf):
        v = i % f
        keep = np.array([float(k != lo + v and k < na and lo + v < na)
                         for k in range(n)])
        out[i] = (yy[i // f] * keep) @ w[i] + b0[i].double().numpy()
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_the_plain_version_is_the_masked_input_and_baddbmm(no_launch, case):
    """`first_layer` on the CPU is the masked path's arithmetic bit for
    bit, and the layer's definition to float32 rounding (sums of at most
    11 terms: 1e-6 of the largest output)."""
    args = _inputs(case)
    got = cfl.first_layer(*args)
    assert torch.equal(got, _masked(*args))
    assert torch.equal(cfl.first_layer_plain(*args), got)
    want = _float64(*args)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert kernels.counts()['first_layer'] == 0


def _today_encode(params, y, activation, seeds, lo):
    """`encode`'s masked path as it was before the kernel."""
    w0 = params['enc'][0][0]
    n = w0.shape[1]
    rows = None
    if seeds is None and (lo or w0.shape[0] != n):
        rows = torch.arange(lo, lo + w0.shape[0])
    mask = tv.loo_mask(n, rows, y.dtype, device=y.device)
    x = (y[:, None] * mask).flatten(0, 1) if seeds else y[None] * mask
    return tv._dense_stack(params['enc'], x, tv.activation_fn(activation))


@pytest.mark.parametrize('case', sorted(c for c in CASES
                                        if 'n_active' not in c))
def test_encode_on_shared_rows_is_todays_masked_encode(no_launch, case):
    """The whole encoder through the wrapper, on the CPU, bit for bit as
    the masked path computed it."""
    w0, b0, y, seeds, lo, _ = _inputs(case)
    rng = np.random.default_rng(1)
    o = w0.shape[-1]
    w1 = torch.from_numpy(rng.normal(0, 0.5, (w0.shape[0], o, 3))
                          .astype(np.float32))
    b1 = torch.zeros(w0.shape[0], 1, 3)
    params = {'enc': [(w0, b0), (w1, b1)]}
    got = tv.encode(params, y, None, 'selu', 'masked', seeds, lo)
    assert torch.equal(got, _today_encode(params, y, 'selu', seeds, lo))


def _with_plain_forward(monkeypatch):
    """The autograd Function on the CPU: its forward's kernel launch
    stood in for by the plain version."""
    monkeypatch.setattr(
        cfl, '_forward_kernel',
        lambda w0, b0, y, seeds, lo, na: cfl.first_layer_plain(
            w0, b0, y, seeds, lo, na))


@pytest.mark.parametrize('case', sorted(CASES))
def test_the_functions_gradients_are_the_masked_paths(no_launch,
                                                      monkeypatch, case):
    """The Function's weight, bias and row gradients against autograd
    through the masked input (float32 sums of a few terms: 1e-6 of the
    largest), and each network's own row of the weight gradient, with the
    padding's rows and networks, an exact zero."""
    _with_plain_forward(monkeypatch)
    w0, b0, y, seeds, lo, na = _inputs(case)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (w0.shape[0], y.shape[-2], w0.shape[-1])).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (w0, b0, y)]
    out = cfl._FirstLayer.apply(*leaves, seeds, lo, na)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (w0, b0, y)]
    ref = torch.autograd.grad(_masked(*ref_leaves, seeds, lo, na),
                              ref_leaves, g)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                   atol=1e-6 * float(r.abs().max()))
    gw = got[0].view(seeds or 1, -1, *w0.shape[1:])
    f, n = gw.shape[1], gw.shape[2]
    for v in range(f):
        if lo + v < n:
            assert torch.count_nonzero(gw[:, v, lo + v]) == 0
        if lo + v >= na:
            assert torch.count_nonzero(gw[:, v]) == 0
    assert torch.count_nonzero(gw[:, :, na:]) == 0
    # the weight gradient alone: no row gradient is computed
    leaves[2].requires_grad_(False)
    out = cfl._FirstLayer.apply(leaves[0], leaves[1], y, seeds, lo, na)
    only = torch.autograd.grad(out, leaves[:2], g)
    assert torch.equal(only[0], got[0]) and torch.equal(only[1], got[1])


# ------------------------------------------------------------ routing --

ROUTES = ['shared rows', 'packed seeds', 'a shard', "'auto' below its bytes",
          'var_ids subset', 'per-network states', 'bf16 compute', 'rank1']


@pytest.mark.parametrize('route', ROUTES)
def test_encode_takes_the_kernel_only_on_shared_float32_rows(monkeypatch,
                                                             route):
    """Shared rows ([B, n] or packed [S, B, n], no var_ids) in float32 go
    through the wrapper, the masked path's first layer included; a
    var_ids subset, per-network states [F, B, n], bfloat16 and the rank-1
    layer keep their own paths."""
    calls = []
    real = cfl.first_layer

    def spy(*args, **kw):
        calls.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(cfl, 'first_layer', spy)
    rng = np.random.default_rng(4)
    n, b, o = 6, 5, 4
    seeds, lo, f = None, 0, n
    if route == 'packed seeds':
        seeds, f = 2, 2 * n
    elif route == 'a shard':
        lo, f = 2, 3
    w0 = torch.from_numpy(rng.normal(0, 0.5, (f, n, o)).astype(np.float32))
    params = {'enc': [(w0, torch.zeros(f, 1, o))]}
    shape = {'packed seeds': (2, b, n), 'per-network states': (f, b, n)}
    y = torch.from_numpy(rng.integers(0, 2, shape.get(route, (b, n)))
                         .astype(np.float32))
    var_ids = torch.tensor([1, 4]) if route == 'var_ids subset' else None
    if var_ids is not None:
        params = {'enc': [(w0[var_ids], torch.zeros(2, 1, o))]}
    if route == 'bf16 compute':
        params = {'enc': [(w0.bfloat16(), torch.zeros(f, 1, o).bfloat16())]}
        y = y.bfloat16()
    layer = {'rank1': 'rank1', "'auto' below its bytes": 'auto'}.get(
        route, 'masked')
    tv.encode(params, y, var_ids, 'selu', layer, seeds, lo)
    took = route in ('shared rows', 'packed seeds', 'a shard',
                     "'auto' below its bytes")
    assert len(calls) == int(took), route
    if took:
        assert calls[0][3:] == (seeds, lo)


# ---------------------------------------------------------- refusals --

def _bad(case):
    w0, b0, y, seeds, lo, na = _inputs('packed seeds')
    args = dict(w0=w0, b0=b0, y=y, seeds=seeds, lo=lo, n_active=na)
    if case == 'w0 2-D':
        args['w0'] = w0[0]
    elif case == 'y of 2 seeds':
        args['y'] = y[:2]
    elif case == 'y [S, B, N+1]':
        args['y'] = torch.zeros(3, y.shape[1], y.shape[2] + 1)
    elif case == 'F not a multiple of S':
        args['w0'], args['b0'] = w0[:-1], b0[:-1]
    elif case == 'b0 [F, O]':
        args['b0'] = b0[:, 0]
    elif case == 'n_active past N':
        args['n_active'] = y.shape[-1] + 1
    elif case == 'networks past N':
        args['lo'] = 1
    elif case == 'on the meta device':
        args = {k: v.to('meta') if isinstance(v, torch.Tensor) else v
                for k, v in args.items()}
    return args


@pytest.mark.parametrize('case', [
    'w0 2-D', 'y of 2 seeds', 'y [S, B, N+1]', 'F not a multiple of S',
    'b0 [F, O]', 'n_active past N', 'networks past N', 'on the meta device'])
def test_the_wrapper_refuses_before_any_launch(no_launch, case):
    with pytest.raises(ValueError):
        cfl.first_layer(**_bad(case))
    assert kernels.counts()['first_layer'] == 0


# -------------------------------------------------------------- plans --

# rows: a single row, the smallest tile's edge and past it, bbc's quality
# recipe (25) and the packed kdd step (32), the 64-row tile's edges, a
# mesh_bbc rank's train rows (125), bbc-score's 95th percentile (246),
# batch 250 and bbc's test split (330)
PLANS = {1: 3, 8: 3, 9: 2, 25: 2, 32: 2, 33: 1, 64: 1, 65: 0, 125: 0,
         246: 0, 250: 0, 330: 0}


@pytest.mark.parametrize('rows', sorted(PLANS))
def test_the_plan_takes_the_smallest_tile_that_holds_the_rows(rows):
    p = cfl.plan(rows)
    assert p.inst == PLANS[rows]
    assert (p.bm, p.bn) == cfl.INSTANCES[p.inst]
    assert rows <= p.bm or p.inst == 0


def test_the_plans_tiles_are_the_kernels():
    """`INSTANCES` lists the kernel's SHAPES table's rows and columns in
    its order, and an empty batch has no plan."""
    table = re.search(r'SHAPES\[INSTANCES\]\[6\] = \{(.*?)\};',
                      SRC.read_text(), re.S).group(1)
    rows = [tuple(int(x) for x in r.split(','))
            for r in re.findall(r'\{([\d, ]+)\}', table)]
    assert [r[:2] for r in rows] == list(cfl.INSTANCES)
    for bm, bn, bk, tm, tn, threads in rows:
        assert threads == (bm // tm) * (bn // tn)
    with pytest.raises(ValueError):
        cfl.plan(0)
