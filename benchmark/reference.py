"""The plain reference: the stacked leave-one-out VQ-VAE, its training step
(loss, gradients, Adam, the EMA codebook update and dead-code restarts),
stage 2's conditional probability table, a Gibbs step and per-row scoring,
in plain PyTorch, float32, with the nearest code found by distances and
argmin. It follows the published design as the JAX package's docs state it
(`docs/design.md`; `pgmvae_tpu/train.py`, `ops/quantizer.py`,
`stage2.py`, `gibbs.py`, `serving.py`), one network row at a time where a
whole tensor would not fit.

It imports nothing of the program and takes nothing that the program made:
the weights and data come from `inputs.py`, and it works out again the
codes, the CPT, the epochs' permutations and the restart draws.

`tf32=True` computes every matrix product in TF32 (the card's TF32 mode; on
the CPU, operands rounded to TF32's 10-bit mantissa): the control, one
precision below the configuration's IEEE float32.

`fault` plants one of the faults the correctness check must catch, so that
the reference put in the program's place reads like a broken program:
'frozen' (a step that returns its state unchanged), 'half_batch' (half of
the batch left out, the mean taken over the rest), 'altered' (an answer
altered where it is produced), 'small_requests' (the answers of requests
of at most 8 rows, 0.4% off: a fault in few rows of the whole).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

B1, B2 = 0.9, 0.999          # Adam (optax defaults)
SMOOTHING = 0.8              # stage-2 CPT (reference core/model.py:88)
LOG_EPS = 1e-5               # log(p + eps) (reference core/model.py:93)
BLOCK_BYTES = 1 << 30        # bound on one row block's largest tensor


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matrix products on the card inside the block when `tf32`;
    IEEE float32 otherwise (and always restored)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), as float32."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def _bmm(a, b, tf32: bool):
    """a @ b batched; on the CPU a TF32 product rounds its operands."""
    if tf32 and not a.is_cuda:
        a, b = _tf32_round(a), _tf32_round(b)
    return torch.bmm(a, b)


def _dense(x, w, b, tf32: bool):
    return _bmm(x, w, tf32) + b


def _loo_mask(n_var: int, var_ids, device) -> torch.Tensor:
    """[F, 1, n_var]: zero at each selected network's own variable."""
    cols = torch.arange(n_var, device=device)
    return (cols[None, :] != var_ids[:, None]).float()[:, None, :]


def encode(enc, y, var_ids, tf32: bool = False):
    """Latents [F, B, D] of networks `var_ids` [F] (their own layers in
    `enc`) on samples y [B, n_var] shared, or [F, B, n_var] one each: each
    network sees y with its own variable zeroed, then selu layers."""
    x = (y[None] if y.dim() == 2 else y) * _loo_mask(
        enc[0][0].shape[1], var_ids, y.device)
    for w, b in enc:
        x = F.selu(_dense(x, w, b, tf32))
    return x


def nearest(z, codebook):
    """Index [F, B] of the code nearest each latent: the squared distance
    sum_d (z_d - W_dk)^2 taken elementwise, so that equal codes (a dead-code
    restart can copy one latent into several) are equally far, and argmin
    takes the first of equals."""
    diff = z[:, :, None, :] - codebook.transpose(1, 2)[:, None, :, :]
    return torch.argmin(torch.sum(diff * diff, dim=3), dim=2)


def _rows_per_block(n_nets: int, width: int) -> int:
    return max(1, BLOCK_BYTES // (4 * n_nets * max(width, 1)))


def codes(weights, cfg: dict, y, var_ids=None, tf32: bool = False):
    """Codes [F, B] of rows y [B, n_var] (or [F, B, n_var]) under networks
    `var_ids` (all of them when None), in blocks of rows."""
    n = cfg['n_var']
    if var_ids is None:
        var_ids = torch.arange(n, device=y.device)
    enc = [(w.index_select(0, var_ids), b.index_select(0, var_ids))
           for w, b in weights['enc']]
    cb = weights['codebook'].index_select(0, var_ids)
    width = max(n, cfg['num_codes'] * cfg['dim'], *cfg['units'])
    step = _rows_per_block(len(var_ids), width)
    out = []
    with torch.no_grad(), precision(tf32):
        for lo in range(0, y.shape[-2], step):
            yb = y[..., lo:lo + step, :]
            out.append(nearest(encode(enc, yb, var_ids, tf32), cb))
    return torch.cat(out, 1)


# ------------------------------------------------------------- stage 2 --
def cpt(weights, cfg: dict, y_train, tf32: bool = False) -> torch.Tensor:
    """p(y_v = 1 | code_v = k), float64 [n_var, K]: (n1 + 0.8) /
    (n1 + n0 + 1.6) from the train split's codes."""
    k = cfg['num_codes']
    c = codes(weights, cfg, y_train, tf32=tf32)                   # [n, N]
    yt = y_train.T.double()
    n1 = torch.zeros((cfg['n_var'], k), dtype=torch.float64,
                     device=y_train.device)
    n0 = torch.zeros_like(n1)
    n1.scatter_add_(1, c, yt)
    n0.scatter_add_(1, c, 1.0 - yt)
    return (n1 + SMOOTHING) / (n1 + n0 + 2 * SMOOTHING)


# ------------------------------------------------------------- scoring --
def score(weights, cfg: dict, table, y, tf32: bool = False,
          fault: Optional[str] = None) -> torch.Tensor:
    """Per-row pseudo-log-likelihood [B] float64 of rows y [B, n_var]: the
    sum over variables of log p(y_v | code_v(y_-v)) under `table`."""
    c = codes(weights, cfg, y, tf32=tf32)                         # [n, B]
    p = torch.gather(table, 1, c)                                 # [n, B]
    yt = y.T.double()
    ll = (yt * torch.log(p + LOG_EPS)
          + (1.0 - yt) * torch.log(1.0 - p + LOG_EPS)).sum(0)
    if fault == 'altered':              # the first row's answer, half off
        ll = ll.clone()
        ll[0] *= 1.5
    if fault == 'small_requests' and y.shape[0] <= 8:   # 0.4% off
        ll = ll * 1.004
    return ll


# --------------------------------------------------------------- Gibbs --
def gibbs_layout(n_var: int, p1: int):
    """(blocks, volume of each block): blocks of p1 variables, the last
    one possibly smaller."""
    blocks = math.ceil(n_var / p1)
    vol = [p1] * (blocks - 1) + [n_var - p1 * (blocks - 1)]
    return blocks, vol


def gibbs_step(weights, cfg: dict, table, state, counts, i: int, u,
               p1: int, burn_in: int, tf32: bool = False,
               fault: Optional[str] = None):
    """Step i of the blockwise chain: block b resamples variable
    b*p1 + i mod vol_b of its state [B, n_var] as u[b] < p(y_v = 1 |
    code); past burn_in*p1 steps (strictly) the draws add into counts
    [B, n_var]. Returns the new (state, counts)."""
    blocks, vol = gibbs_layout(cfg['n_var'], p1)
    var = torch.tensor([b * p1 + i % vol[b] for b in range(blocks)],
                       device=state.device)
    c = codes(weights, cfg, state, var, tf32)                    # [blk, B]
    p = table[var[:, None], c].float()
    draw = (u < p).float()
    if fault == 'altered':              # block 0's answers, inverted
        draw[0] = 1.0 - draw[0]
    state = state.clone()
    counts = counts.clone()
    rows = torch.arange(state.shape[1], device=state.device)
    for b in range(blocks):
        state[b, rows, var[b]] = draw[b]
        if i > burn_in * p1:
            counts[:, var[b]] += draw[b]
    return state, counts


# ------------------------------------------------------------ training --
def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch `epoch`'s generator, from (seed, epoch) alone: a
    numpy SeedSequence's first 64-bit word, halved."""
    mixed = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), epoch])
    return int(mixed.generate_state(1, np.uint64)[0] >> np.uint64(1))


def epoch_permutation(seed: int, epoch: int, n: int, device):
    """(The order [n] in which epoch `epoch` takes the train rows, its
    generator after drawing it): the epoch's batches are that order's runs
    of B rows, and its restarts draw from that generator next."""
    g = torch.Generator(device=device).manual_seed(epoch_seed(seed, epoch))
    return torch.randperm(n, generator=g, device=device), g


def restart_rows(n: int, k: int, generator, w, device):
    """The batch row [n, K] a dead-code restart takes for each (network,
    code): uniform over the rows of weight > 0, from one uniform draw."""
    u = torch.rand((n, k), generator=generator, device=device)
    valid = torch.nonzero(w > 0)[:, 0]
    j = torch.clamp((u * float(valid.numel())).long(), max=valid.numel() - 1)
    return valid[j]


def _forward(params, codebook, cfg: dict, y, w, tf32: bool):
    """(loss, z, codes): mse over each network's leave-one-out
    reconstruction plus cost times the commitment loss, means weighted by
    the sample weights w."""
    n, d = cfg['n_var'], cfg['dim']
    var_ids = torch.arange(n, device=y.device)
    z = encode(params['enc'], y, var_ids, tf32)                     # [n,B,D]
    with torch.no_grad():
        idx = nearest(z, codebook)
    q = torch.gather(codebook.transpose(1, 2), 1,
                     idx[:, :, None].expand(-1, -1, d))
    wsum = torch.sum(w)
    # the EMA codebook takes no gradient: the commitment term alone
    e_loss = torch.sum((q - z) ** 2 * w[None, :, None]) / (n * d * wsum)
    x = z + (q - z).detach()
    for li, (wt, b) in enumerate(params['dec']):
        x = _dense(x, wt, b, tf32)
        x = torch.sigmoid(x) if li == len(params['dec']) - 1 else F.selu(x)
    mask = _loo_mask(n, var_ids, y.device)
    mse = torch.sum((x - y[None]) ** 2 * mask * w[None, :, None]) / (
        n * (n - 1) * wsum)
    loss = mse + cfg['cost'] * e_loss
    if cfg.get('l2_reg', 0.0):
        loss = loss + cfg['l2_reg'] * sum(
            torch.sum(wt * wt) for stack in ('enc', 'dec')
            for wt, _ in params[stack])
    return loss, z.detach(), idx


def norms(t: torch.Tensor) -> List[float]:
    """Each network's norm of a leaf [networks, ...], summed in float64 (a
    float32 sum over the 2.6 M elements of kdd's codebook is off by ~3e-5
    on the CPU, far above the gaps compared)."""
    return torch.linalg.vector_norm(t.double().flatten(1), dim=1).tolist()


def _leaves(params) -> List[torch.Tensor]:
    return [t for stack in ('enc', 'dec') for layer in params[stack]
            for t in layer]


def train(weights, cfg: dict, batches, generator=None, steps: int = 3,
          tf32: bool = False, fault: Optional[str] = None) -> dict:
    """`steps` training steps from `weights` on `batches` ([B, n_var]
    each, all rows of weight 1), restarts drawn from `generator`. Returns
    the readings the check compares: 'loss' [steps], 'grad1' (the first
    step's gradient norm of each leaf, enc then dec, (w, b) a layer) and
    'delta' (each leaf's change after the steps, then the EMA codebook's),
    each norm [leaf][network] (see `norms`)."""
    dev = weights['codebook'].device
    params = {s: [(w.clone().requires_grad_(), b.clone().requires_grad_())
                  for w, b in weights[s]] for s in ('enc', 'dec')}
    leaves = _leaves(params)
    start = [t.detach().clone() for t in leaves]
    cb0 = weights['codebook'].clone()
    codebook = cb0.clone()
    n, k = cfg['n_var'], cfg['num_codes']
    counts = torch.zeros((n, k), device=dev)
    dw = torch.zeros_like(codebook)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    decay, lr, eps = cfg['decay'], cfg['learning_rate'], cfg['adam_eps']
    losses, grad1 = [], None
    with precision(tf32):
        for t in range(1, steps + 1):
            y = batches[t - 1]
            w = torch.ones(y.shape[0], device=dev)
            if fault == 'half_batch':
                w[y.shape[0] // 2:] = 0.0
            loss, z, idx = _forward(params, codebook, cfg, y, w, tf32)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = [norms(g) for g in grads]
            if fault == 'frozen':
                continue
            with torch.no_grad():
                for p, g, m, v in zip(leaves, grads, mu, nu):
                    m.mul_(B1).add_((1.0 - B1) * g)
                    v.mul_(B2).add_((1.0 - B2) * g * g)
                    mh = m / (1.0 - B1 ** t)
                    vh = v / (1.0 - B2 ** t)
                    p.sub_(lr * mh / (torch.sqrt(vh) + eps))
                # the EMA codebook from this step's latents and codes
                onehot = F.one_hot(idx, k).float() * w[None, :, None]
                counts = decay * counts + (1 - decay) * onehot.sum(1)
                dw = decay * dw + (1 - decay) * torch.bmm(
                    z.transpose(1, 2), onehot)
                bias = 1.0 - decay ** t
                ema_c = counts / bias
                total = ema_c.sum(1, keepdim=True)
                smooth = (ema_c + cfg['epsilon']) / (
                    total + k * cfg['epsilon']) * total
                codebook = (dw / bias) / smooth[:, None, :]
                if cfg['dead_code_threshold'] > 0 and generator is not None:
                    rows = restart_rows(n, k, generator, w, dev)   # [n, K]
                    dead = counts / bias < cfg['dead_code_threshold']
                    cand = torch.gather(
                        z, 1, rows[:, :, None].expand(-1, -1, cfg['dim'])
                    ).transpose(1, 2)                                 # [n,D,K]
                    codebook = torch.where(dead[:, None], cand, codebook)
                    counts = torch.where(dead, torch.full_like(counts, bias),
                                         counts)
                    dw = torch.where(dead[:, None], bias * cand, dw)
    delta = [norms(p.detach() - s) for p, s in zip(leaves, start)]
    delta.append(norms(codebook - cb0))
    return {'loss': losses, 'grad1': grad1, 'delta': delta}


def cpt_cells_off(table, ref) -> float:
    """The share of CPT cells that differ from the reference's."""
    return float(np.mean(np.abs(np.asarray(table) - np.asarray(ref))
                         > 1e-12))


def gap_by_leaf(program, ref, scale_ref) -> np.ndarray:
    """|program - ref| of each leaf's norm over the larger of the
    reference's norm of that leaf and of the median leaf (by `scale_ref`'s
    median over the leaves); with norms [leaf][network], network by
    network."""
    p, r = np.asarray(program, float), np.asarray(ref, float)
    med = np.median(np.asarray(scale_ref, float), axis=0)
    return np.abs(p - r) / np.maximum(np.abs(r), med)
