"""Entry points of the port (the counterpart of the JAX package's
`__graft_entry__.py`).

- entry(device): a forward step (the loss and reconstruction of the
  flagship batched VQ-VAE) with example arguments.
- dryrun_multichip(n, device): train on an (n/2, 2) ('data', 'model') mesh
  of n ranks, data and variable-axis sharded, against the single-device
  replay of the same run, and print the JAX package's `dryrun_multichip
  ok: ...` line. On a GPU with fewer cards than ranks the ranks share it
  over gloo; with device='cpu' they run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _flagship_cfg():
    from pgmvae_tpu_torch.models import VqVaeConfig
    # audio-scale flagship: 100 variables, tuned widths from the registry
    return VqVaeConfig(n_var=100, units=(80, 60, 40, 30), dim=10,
                       num_codes=64, cost=0.25, decay=0.99, quantizer='ema')


def entry(device=None):
    """Return (fn, example_args): the stage-1 forward (total loss and
    reconstruction) of the flagship model on `device` (None means CUDA)."""
    from pgmvae_tpu_torch import resolve_device
    from pgmvae_tpu_torch.models import apply_model, init_model
    from pgmvae_tpu_torch.models.vqvae import loo_mask

    device = resolve_device(device)
    cfg = _flagship_cfg()
    params, codebook = init_model(torch.Generator().manual_seed(0), cfg,
                                  device)
    y = (torch.rand((128, cfg.n_var), generator=torch.Generator()
                    .manual_seed(1)) < 0.5).float().to(device)

    def fn(params, codebook, y):
        out = apply_model(params, codebook, y, cfg)
        mask = loo_mask(cfg.n_var, None, y.dtype, device=y.device)
        n = cfg.n_var
        mse = torch.sum(((out.recon - y[None]) ** 2) * mask) / (
            n * (n - 1) * y.shape[0])
        return mse + cfg.cost * out.e_loss, out.recon

    return fn, (params, codebook, y)


def _dryrun_setup(n_devices: int):
    """(data axis, model axis, cfg, batch, n_train, samples) of the dry run:
    the model axis 2 when n is even, the variable axis 17 padded to a
    multiple of it (the padded network is inert), 8 steps an epoch."""
    from pgmvae_tpu_torch.models import VqVaeConfig
    model_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data_axis = n_devices // model_axis
    n_active = 17
    n_var = -(-n_active // model_axis) * model_axis
    cfg = VqVaeConfig(n_var=n_var, n_active=n_active if n_var != n_active
                      else None, units=(15, 14, 13, 12), dim=8, num_codes=32,
                      cost=0.25, decay=0.99, quantizer='ema')
    batch = 8 * data_axis
    n_train = 8 * batch
    rng = np.random.default_rng(0)
    y_host = rng.integers(0, 2, size=(n_train, n_active)).astype(np.float32)
    return data_axis, model_axis, cfg, batch, n_train, y_host


def _dryrun_runs(device, n_devices: int, mesh_ctx=None) -> dict:
    """The dry run's two measurements on one rank (or on one device without
    `mesh_ctx`): two EMA epochs with stage 2, and one dead-code-restart
    step at threshold 0.5; everything gathered to the whole model."""
    from pgmvae_tpu_torch.models.vqvae import param_leaves
    from pgmvae_tpu_torch.parallel import MeshContext
    from pgmvae_tpu_torch.stage2 import Stage2
    from pgmvae_tpu_torch.train import Trainer

    _, _, cfg, batch, n_train, y_host = _dryrun_setup(n_devices)
    mesh = mesh_ctx or MeshContext(None)

    tr = Trainer(cfg, 0.01, batch, n_train, mesh_ctx=mesh, device=device)
    st = tr.init_state(0)
    st, _ = tr.fit(st, y_host, epochs=2, seed=5)
    s2 = Stage2(cfg, mesh_ctx=mesh, device=device)
    cb = tr.codebook(st)
    n1, n0 = s2.counts(st.params, cb, y_host)
    dist = s2.cpt(st.params, cb, y_host)
    pll = s2.pseudo_log_likelihood(st.params, cb, y_host, dist)
    whole = tr.unshard_state(st)

    tr_dcr = Trainer(cfg._replace(dead_code_threshold=0.5), 0.01, batch,
                     n_train, mesh_ctx=mesh, device=device)
    sd = tr_dcr.init_state(0)
    yb = torch.as_tensor(np.pad(y_host[:batch],
                                ((0, 0), (0, cfg.n_var - y_host.shape[1]))),
                         device=tr_dcr.device)
    w = torch.ones(batch, device=tr_dcr.device)
    sd, m = tr_dcr.train_step(sd, yb, w, torch.Generator(
        device=tr_dcr.device).manual_seed(7))
    return {'params': [p.cpu().numpy() for p in param_leaves(whole.params)],
            'codebook': whole.ema.codebook.cpu().numpy(), 'n1': n1,
            'n0': n0, 'pll': float(pll),
            'codebook_dcr': tr_dcr.unshard_state(sd).ema.codebook.cpu()
            .numpy(), 'loss_dcr': float(m[0])}


def _dryrun_rank(device, n_devices: int) -> dict:
    """One rank of the dry run's mesh."""
    from pgmvae_tpu_torch.parallel import MeshContext, make_mesh
    data_axis, model_axis = _dryrun_setup(n_devices)[:2]
    ctx = MeshContext(make_mesh(data_axis, model_axis, device))
    out = _dryrun_runs(device, n_devices, ctx)
    out['mesh'] = ctx.describe()
    return out


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Two EMA epochs and stage 2 on an (n/2, 2) mesh of `n_devices` ranks
    against the single-device replay, and the dead-code-restart step, held
    to the JAX package's tolerances; prints and returns its line. `device`
    (None means CUDA) is where the ranks and the replay run."""
    line = dryrun_report(n_devices, device)['line']
    print(line, flush=True)
    return line


def dryrun_report(n_devices: int, device=None) -> dict:
    """`dryrun_multichip`'s run and holds without the print: its line, the
    deltas and the ranks' summed kernel launches."""
    from pgmvae_tpu_torch import resolve_device
    from pgmvae_tpu_torch.parallel import mesh as pmesh

    device = resolve_device(device)
    data_axis, model_axis, cfg = _dryrun_setup(n_devices)[:3]
    ranks = pmesh.spawn(_dryrun_rank, (n_devices,), world_size=n_devices,
                        device=device, timeout=900,
                        collective_timeout=600)
    m = ranks[0].value
    one = _dryrun_runs(device, n_devices)

    d_cb = float(np.max(np.abs(m['codebook'] - one['codebook'])))
    d_par = max(float(np.max(np.abs(a - b)))
                for a, b in zip(m['params'], one['params']))
    np.testing.assert_allclose(m['codebook'], one['codebook'], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(m['n1'], one['n1'])  # bit-equal counts
    np.testing.assert_array_equal(m['n0'], one['n0'])
    if not (abs(m['pll'] - one['pll']) < 1e-5 and np.isfinite(m['pll'])):
        raise AssertionError(f'PLL {m["pll"]} against {one["pll"]}')
    np.testing.assert_allclose(m['codebook_dcr'], one['codebook_dcr'],
                               rtol=1e-4, atol=1e-5)
    d_dcr = float(np.max(np.abs(m['codebook_dcr'] - one['codebook_dcr'])))
    line = (f'dryrun_multichip ok: mesh={(data_axis, model_axis)} '
            f'n_var={cfg.n_var} (active {cfg.active_vars}, padded) '
            f'pll={m["pll"]:.6f} (single-device {one["pll"]:.6f}, '
            f'delta {abs(m["pll"] - one["pll"]):.2e}); '
            f'2-epoch EMA parity: max|codebook delta|={d_cb:.2e} '
            f'max|param delta|={d_par:.2e}; stage-2 counts bit-equal; '
            f'dead-code-restart step: max|codebook delta|={d_dcr:.2e} '
            f'loss delta={abs(m["loss_dcr"] - one["loss_dcr"]):.2e}; '
            f'backend {m["mesh"]["backend"]} on '
            f'{", ".join(sorted(set(r.device for r in ranks)))}')
    return {'line': line, 'pll_delta': abs(m['pll'] - one['pll']),
            'codebook_delta': d_cb, 'param_delta': d_par,
            'restart_codebook_delta': d_dcr,
            'launches': pmesh.summed_launches(ranks)}
