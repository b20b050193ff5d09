"""The port's device mesh (`pgmvae_tpu_torch.parallel`) on gloo worlds of
CPU processes, held to the tolerances of tests/test_sharding.py: for each
mesh shape (8, 1), (1, 8) and (2, 4) one world of 8 ranks takes every
measurement once (a module-scoped fixture), and each check is a case of
its own against the port's single-device run or the JAX package (on the 8
fake CPU devices of tests/conftest.py): a whole epoch, the state's layout,
the first dead-code-restart step, the rank-1 first layer and its inert
diagonal, stage-2 counts (with and without parents, bit-equal to both of
JAX's count paths, einsum and scatter), one train step against JAX's on the same mesh, the
padded variable axis through `dryrun_multichip`, and the spawn helper's
failures.

The functions the ranks run live at this module's top level, which
imports no JAX: the ranks import it by name and stay light."""

import time

import numpy as np
import pytest
import torch

from pgmvae_tpu_torch.models import vqvae as tv
from pgmvae_tpu_torch.parallel import mesh as pm
from pgmvae_tpu_torch.stage2 import Stage2
from pgmvae_tpu_torch.train import Trainer

KW = dict(n_var=8, units=(7, 6), dim=4, num_codes=10, quantizer='ema')
CFG = tv.VqVaeConfig(**KW)
SHAPES = [(8, 1), (1, 8), (2, 4)]
# (M, the JAX package's path: its scatter if True, else its einsum)
COUNT_CASES = [(0, False), (2, False), (0, True), (2, True)]
TIMEOUT = 300          # seconds a world may take on a loaded CPU


def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, CFG.n_var)).astype(np.float32)


def _restart_cfg():
    return CFG._replace(dead_code_threshold=0.5, num_codes=32)


def _params_np(state):
    return [p.detach().cpu().numpy() for p in tv.param_leaves(state.params)]


def _parents(m):
    if not m:
        return None
    from pgmvae_tpu_torch.stage2 import select_parents
    return select_parents(_data(300, seed=3), m)


def _runs(device, mesh_ctx=None, init=None, step_state=None):
    """Every measurement of the module on one rank of `mesh_ctx` (or on one
    device): an epoch, the rank-1 epoch, the first restart step, stage-2
    counts of the params `init` (numpy, the JAX package's) and a step from
    `step_state` (a port TrainState of the JAX package's numbers)."""
    mesh = mesh_ctx or pm.MeshContext(None)
    y = torch.as_tensor(_data())
    # work only rank 0 does (the driver's CMLL): every rank gets its value
    out = {'on_rank0': mesh.on_rank0(lambda: 1.5 + mesh.rank)}
    tr = Trainer(CFG, 0.01, 64, len(y), mesh_ctx=mesh, device=device)
    st = tr.init_state(0)
    out['layout'] = {
        'stacked': [(tuple(x.shape), x.numel() * x.element_size())
                    for x in tv.param_leaves(st.params) + list(st.ema[:3])],
        'step': tuple(st.step.shape)}
    st, m = tr.run_epoch(st, y, tr.epoch_generator(5, 0))
    whole = tr.unshard_state(st)
    out['epoch'] = (m.numpy(), _params_np(whole),
                    whole.ema.codebook.numpy())
    # the same epoch streamed from the host in chunks of 3 steps
    tr = Trainer(CFG, 0.01, 64, len(y), mesh_ctx=mesh, stream_bytes=0,
                 stream_chunk_bytes=3 * 64 * CFG.n_var * 4, device=device)
    st, hist = tr.fit(tr.init_state(0), y.numpy(), 1, seed=5)
    out['streamed'] = (hist[0].loss, _params_np(tr.unshard_state(st)))

    cfg1 = CFG._replace(first_layer='rank1')
    tr = Trainer(cfg1, 0.01, 64, len(y), mesh_ctx=mesh, device=device)
    st, m = tr.run_epoch(tr.init_state(0), y, tr.epoch_generator(5, 0))
    out['rank1'] = (m.numpy(), _params_np(tr.unshard_state(st)))

    tr = Trainer(_restart_cfg(), 0.01, 64, 64, mesh_ctx=mesh, device=device)
    st, m = tr.train_step(tr.init_state(0), torch.as_tensor(_data(64, 5)),
                          torch.ones(64), torch.Generator().manual_seed(7))
    out['restart'] = (float(m[0]),
                      tr.unshard_state(st).ema.codebook.numpy())

    if init is not None:
        params, codebook = init
        params = tv.map_params(lambda p: mesh.put(p, 'model'),
                               tv.map_params(torch.as_tensor, params))
        codebook = mesh.put(codebook, 'model')
        y2 = _data(300, seed=3)
        out['counts'] = {
            m: Stage2(CFG, chunk=64, mesh_ctx=mesh, parents=_parents(m),
                      device=device).counts(params, codebook, y2)
            for m in sorted({m for m, _ in COUNT_CASES})}
    if step_state is not None:
        tr = Trainer(CFG, 0.01, 64, 64, mesh_ctx=mesh, device=device)
        yb, w = _step_batch()
        st, m = tr.train_step(tr.shard_state(step_state), torch.as_tensor(yb),
                              torch.as_tensor(w))
        whole = tr.unshard_state(st)
        out['jax_step'] = (m.numpy(), _params_np(whole),
                           [t.numpy() for t in whole.ema[:3]],
                           [t.numpy() for t in
                            tv.param_leaves(whole.opt_state.mu)])
    return out


def _step_batch():
    y = _data(64, seed=1)
    w = np.ones(64, np.float32)
    w[5] = 0.0                                   # one weight-0 row
    return y, w


def _world_rank(device, shape, init, step_state):
    ctx = pm.MeshContext(pm.make_mesh(*shape, device=device))
    return _runs(device, ctx, init, step_state)


def _raise_on_rank1(device):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError('rank 1 fails on purpose')
    return dist.get_rank()


def _sleep(device, seconds):
    time.sleep(seconds)


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope='module')
def jax_init():
    """The JAX package's initial TrainState (numpy leaves) of CFG."""
    import jax
    from pgmvae_tpu.models import VqVaeConfig as JCfg
    from pgmvae_tpu.train import Trainer as JTrainer
    jtr = JTrainer(JCfg(**KW), 0.01, 64, 64)
    return jax.tree.map(np.asarray, jtr.init_state(jax.random.PRNGKey(0)))


@pytest.fixture(scope='module')
def single():
    return _runs('cpu')


@pytest.fixture(scope='module', params=SHAPES, ids=lambda s: f'{s[0]}x{s[1]}')
def world(request, jax_init):
    """One world of 8 ranks for the mesh shape; every rank's results."""
    from pgmvae_tpu_torch.convert import train_state_from_jax
    shape = request.param
    init = (jax_init.params, jax_init.ema.codebook)
    step_state = train_state_from_jax(jax_init, CFG, 'cpu')
    ranks = pm.spawn(_world_rank, (shape, init, step_state), world_size=8,
                     device='cpu', timeout=TIMEOUT, collective_timeout=TIMEOUT)
    return shape, [r.value for r in ranks]


def _replicas_equal(world, key, pick=lambda v: v):
    """Every rank's gathered model under `key` is bit-equal to that of the
    rank with the same model coordinate on data rank 0: no data replica
    drifts from the others."""
    (_, model), ranks = world
    for r, out in enumerate(ranks):
        for a, b in zip(pick(out[key]), pick(ranks[r % model][key])):
            np.testing.assert_array_equal(a, b, err_msg=f'rank {r} {key}')


# ----------------------------------------------------- against the port --

def test_epoch_parity_across_mesh_shapes(world, single):
    _, ranks = world
    m_mesh, p_mesh, cb_mesh = ranks[0]['epoch']
    m_one, p_one, cb_one = single['epoch']
    np.testing.assert_allclose(m_mesh[0], m_one[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(p_mesh, p_one):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cb_mesh, cb_one, rtol=1e-4, atol=1e-5)
    for r in ranks[1:]:        # every rank reads the same metrics
        np.testing.assert_array_equal(r['epoch'][0], m_mesh)
    _replicas_equal(world, 'epoch', lambda v: v[1] + [v[2]])


def test_streamed_epoch_on_the_mesh_equals_in_core(world):
    """`fit` streaming host chunks under the mesh: bit-equal to the mesh's
    in-core epoch (the same permutation, batches and steps)."""
    _, ranks = world
    loss, params = ranks[0]['streamed']
    m_mesh, p_mesh, _ = ranks[0]['epoch']
    assert loss == float(m_mesh[0])
    for a, b in zip(params, p_mesh):
        np.testing.assert_array_equal(a, b)


def test_rank0_work_reaches_every_rank(world):
    _, ranks = world
    assert [r['on_rank0'] for r in ranks] == [1.5] * 8


def test_state_sharding_layout(world, single):
    """Each rank holds 1/model of every stacked leaf's bytes, exactly; the
    step counter is a replicated scalar."""
    (_, model), ranks = world
    whole = single['layout']['stacked']
    for r in ranks:
        assert r['layout']['step'] == ()
        for (shape, nbytes), (full_shape, full_bytes) in zip(
                r['layout']['stacked'], whole):
            assert nbytes * model == full_bytes, (shape, full_shape)
            assert shape[0] * model == full_shape[0]


def test_dead_code_restart_mesh_parity(world, single):
    """The first step's restarts: usage values are exact counts, so the
    dead codes and the drawn rows (global [n_var, K] draws, rows of the
    gathered batch) are the single device's."""
    _, ranks = world
    loss, cb = ranks[0]['restart']
    np.testing.assert_allclose(loss, single['restart'][0], rtol=1e-5)
    np.testing.assert_allclose(cb, single['restart'][1], rtol=1e-4,
                               atol=1e-5)
    _replicas_equal(world, 'restart', lambda v: [v[1]])


def test_rank1_first_layer_mesh_parity(world, single):
    """first_layer='rank1' on the mesh trains to the single device's params,
    and each network's diagonal W[v, v, :] (its own global column) stays at
    its initial value."""
    _, ranks = world
    m_mesh, p_mesh = ranks[0]['rank1']
    m_one, p_one = single['rank1']
    np.testing.assert_allclose(m_mesh[0], m_one[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(p_mesh, p_one):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    _replicas_equal(world, 'rank1', lambda v: v[1])
    tr = Trainer(CFG._replace(first_layer='rank1'), 0.01, 64, 512,
                 device='cpu')
    params = tr.init_state(0).params
    w0_init = params['enc'][0][0]
    at = [x is w0_init for x in tv.param_leaves(params)].index(True)
    idx = np.arange(CFG.n_var)
    np.testing.assert_array_equal(p_mesh[at][idx, idx, :],
                                  w0_init.numpy()[idx, idx, :])


@pytest.mark.parametrize('m,scatter', COUNT_CASES)
def test_stage2_counts_bit_equal_to_jax(world, jax_init, m, scatter):
    """Stage-2 counts of the JAX package's params on the mesh equal JAX's
    from either of its paths (einsum and scatter), bit for bit, with and
    without joint-code parents."""
    from pgmvae_tpu.models import VqVaeConfig as JCfg
    from pgmvae_tpu.stage2 import Stage2 as JStage2
    _, ranks = world
    ref = JStage2(JCfg(**KW), chunk=64, parents=_parents(m),
                  scatter=scatter).counts(jax_init.params,
                                          jax_init.ema.codebook,
                                          _data(300, seed=3))
    for r in ranks:             # every rank holds the global tables
        n1, n0 = r['counts'][m]
        np.testing.assert_array_equal(n1, ref[0])
        np.testing.assert_array_equal(n0, ref[1])


# ------------------------------------------------------ against JAX --

def test_train_step_matches_jax_on_the_same_mesh(world, jax_init):
    """One train step from the JAX package's initial state on the same
    make_mesh(data, model) in both packages (JAX on its 8 fake CPU
    devices), (2, 4) among them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from pgmvae_tpu.models import VqVaeConfig as JCfg
    from pgmvae_tpu.parallel import MeshContext, make_mesh
    from pgmvae_tpu.train import Trainer as JTrainer
    shape, ranks = world
    ctx = MeshContext(make_mesh(*shape))
    jtr = JTrainer(JCfg(**KW), 0.01, 64, 64, mesh_ctx=ctx)
    js = jtr.shard_state(jax.tree.map(jnp.asarray, jax_init))
    yb, w = _step_batch()
    js2, jm = jax.jit(jtr.train_step)(js, ctx.put(jnp.asarray(yb),
                                                  P('data', None)),
                                      ctx.put(jnp.asarray(w), P('data')))
    js2 = jax.tree.map(np.asarray, js2)
    metrics, params, ema, mu = ranks[0]['jax_step']
    for got, ref in zip(params, jax.tree.leaves(js2.params)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for got, ref in zip(ema, js2.ema[:3]):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    for got, ref in zip(mu, jax.tree.leaves(
            js2.opt_state.inner_state[0].mu)):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(metrics, np.asarray(jm), rtol=1e-5)


# ------------------------------------------------- the padded axis --

def test_dryrun_multichip_padded_axis_on_cpu(capsys):
    """`dryrun_multichip(8)`: a (4, 2) mesh at n_var 18 with 17 active (the
    padded network invisible), two EMA epochs and stage 2 against the
    single-device replay, and the restart step, at JAX's tolerances."""
    from pgmvae_tpu_torch.__graft_entry__ import dryrun_multichip
    line = dryrun_multichip(8, device='cpu')
    assert line.startswith('dryrun_multichip ok: mesh=(4, 2) n_var=18 '
                           '(active 17, padded)'), line
    assert 'stage-2 counts bit-equal' in line and 'backend gloo' in line
    assert line in capsys.readouterr().out


# ------------------------------------------------------ the helpers --

def test_shard_rule():
    rule = pm.shard_leading_axis(8)
    assert rule(torch.zeros((8, 3, 4))) is True
    assert rule(torch.zeros((4, 3))) is False
    assert rule(torch.zeros(())) is False
    assert rule(3.0) is False


def test_no_mesh_is_a_no_op():
    ctx = pm.MeshContext(None)
    t = torch.arange(6.0).view(3, 2)
    assert ctx.all_reduce(t) is t and ctx.all_gather(t, 'data') is t
    assert ctx.local_rows(t) is t and ctx.var_range(8) == (0, 8)
    assert ctx.captures and ctx.describe() is None
    assert ctx.on_rank0(lambda: 2.5) == 2.5
    np.testing.assert_array_equal(ctx.put(t.numpy(), 'model'), t)
    np.testing.assert_array_equal(ctx.put(t.numpy(), 'data'), t)


@pytest.fixture
def world_of_one(tmp_path):
    """This process as the one rank of a gloo world, for the test's span."""
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method=f'file://{tmp_path}/store',
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_device_needs_cuda(world_of_one, monkeypatch):
    """`make_mesh(device=None)` means CUDA: without it, it raises rather
    than place the ranks on the CPU; the CPU is taken only when asked."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pm.make_mesh(1, 1)
    ctx = pm.MeshContext(pm.make_mesh(1, 1, device='cpu'))
    assert ctx.describe() == {'shape': [1, 1], 'backend': 'gloo',
                              'device': 'cpu'}


def test_spawn_without_a_device_needs_cuda(monkeypatch):
    """`spawn(fn)` with no device means CUDA and raises without it, before
    any rank starts."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pm.spawn(_sleep, (600,), world_size=2, timeout=5)


def test_placement_picks_the_backend():
    assert pm.placement(4, 'cpu') == ('gloo', ['cpu'] * 4)


def test_build_kernels_builds_every_kernel_library(monkeypatch):
    """`build_kernels`, run before a CUDA world spawns, builds every
    registered kernel library, the reconstruction pair's included: each
    registered build, stubbed, records its call."""
    from pgmvae_tpu_torch.ops import (cuda_ema, cuda_recon, cuda_vq,
                                      fused_adam, kernels)
    built, registered = [], kernels.builds()
    monkeypatch.setattr(kernels, '_BUILDS', {
        name: (lambda build=build: built.append(build))
        for name, build in registered.items()})
    pm.build_kernels()
    assert len(built) == len(registered)
    assert set(built) == set(registered.values()) >= {
        cuda_vq.build, fused_adam.build, cuda_ema.build, cuda_recon.build}


def test_a_rank_exception_is_raised_in_the_caller():
    with pytest.raises(Exception, match='rank 1 fails on purpose'):
        pm.spawn(_raise_on_rank1, (), world_size=2, device='cpu',
                 timeout=TIMEOUT, collective_timeout=TIMEOUT)


def test_a_hung_world_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        pm.spawn(_sleep, (600,), world_size=2, device='cpu', timeout=5)
    assert time.monotonic() - t0 < 60
