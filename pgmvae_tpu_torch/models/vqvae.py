"""The batched multi-network VQ-VAE (the port of
`pgmvae_tpu/models/vqvae.py`): the forward pass, the training forward
`apply_model` with its losses, and the rank-1 first layer's backward.

`n_var` independent dense autoencoders run as ONE model: every parameter
leaf carries a leading `n_var` axis and each dense layer is one
`torch.baddbmm` of `[n,B,i]` by `[n,i,o]`. Params keep the JAX pytree
layout as a plain dict of tensors, `{'enc': [(w, b), ...], 'dec': [...]}`,
with the codebook `[n, D, K]` beside it (or inside it, as
`params['codebook']`, when the 'vq' quantizer trains it with Adam).

Leave-one-out uses the JAX package's padded masked design: every network
sees the full sample y [B, n_var] with its own variable's input multiplied
by zero, so the first/last stacked kernels are full [n, n, u] and their
diagonal rows/columns are inert. On shared float32 rows the first layer
is one kernel (`ops/cuda_first_layer.py`) that gives the masked input's
terms without building it: each network's own input is dropped as its
weights are loaded.

Packed seeds (`seeds=S`): S models stacked on axis 0, every leaf
[S * n, ...], each with its own batch, y [S, B, n_var]; a layer is still one
`torch.baddbmm`, now over S * n networks. bf16 compute passes bfloat16
params and samples: the layers run in bfloat16 and the mask takes y's dtype.

A shard of the variable axis (a device mesh's model rank, `lo`): the leaves
hold networks [lo, lo + n_local) of n_var, and each network's inert input
is its GLOBAL variable: the mask's zero sits at column lo + i of row i, and
the rank-1 first layer's diagonal is W[i, lo + i, :].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.ops import initializers as pinit
from pgmvae_tpu_torch.ops import quantizer as q


class VqVaeConfig(NamedTuple):
    """Exactly the fields and defaults of the JAX package's VqVaeConfig
    (checkpoint headers store `cfg._asdict()`)."""
    n_var: int
    units: Tuple[int, ...]       # hidden widths (encoder order)
    dim: int                     # latent / embedding dimension D
    num_codes: int               # codebook size K
    cost: float = 0.25           # commitment cost beta
    decay: float = 0.99          # EMA decay gamma
    quantizer: str = 'ema'       # 'ema' | 'vq' | 'naive'
    zero_debias: bool = True     # TF assign_moving_average default
    epsilon: float = 1e-5        # EMA Laplace smoothing
    dead_code_threshold: float = 0.0  # >0: restart codes with EMA usage < t
    fan_mode: str = 'tf_stacked'
    dtype: str = 'float32'
    vq_impl: str = 'auto'   # 'auto' | 'xla' | 'pallas' | 'pallas_interpret'
    matmul_precision: str = 'default'  # jax.default_matmul_precision name
    activation: str = 'selu'     # hidden activation
    l2_reg: float = 0.0          # L2 penalty on dense kernels
    n_active: Optional[int] = None  # true variable count when n_var is
    #                              padded; networks/columns >= n_active are
    #                              inert and sliced out of stage-2 counts
    compute_dtype: str = 'f32'   # 'f32' | 'bf16' (training only)
    first_layer: str = 'masked'  # 'masked' | 'rank1' | 'auto'

    @property
    def effective_codes(self) -> int:
        """Number of discrete codes stage 2 counts over."""
        return 2 ** self.dim if self.quantizer == 'naive' else self.num_codes

    @property
    def active_vars(self) -> int:
        """True (unpadded) variable count."""
        return self.n_active if self.n_active is not None else self.n_var


ACTIVATIONS = {
    'selu': F.selu,
    'relu': F.relu,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),   # jax.nn.gelu default
    'elu': F.elu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'linear': lambda x: x,
}


def activation_fn(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f'unknown activation {name!r}; '
                         f'choose from {sorted(ACTIVATIONS)}') from None


def _layer_dims(cfg: VqVaeConfig):
    # padded layout: first input and last output are full n_var wide; the
    # diagonal row/column of those stacked kernels is inert (see module doc)
    enc_in = (cfg.n_var,) + tuple(cfg.units)
    enc_out = tuple(cfg.units) + (cfg.dim,)
    dec_in = (cfg.dim,) + tuple(reversed(cfg.units))
    dec_out = tuple(reversed(cfg.units)) + (cfg.n_var,)
    return tuple(zip(enc_in, enc_out)), tuple(zip(dec_in, dec_out))


def loo_mask(n_var: int, var_ids: Optional[torch.Tensor] = None,
             dtype=torch.float32, n_active: Optional[int] = None,
             device=None) -> torch.Tensor:
    """Leave-one-out mask [F, 1, n_var]: 0 at each selected network's own
    variable, 1 elsewhere. With `n_active < n_var`, columns >= n_active and
    whole rows for networks >= n_active are zeroed too. The mask lands on
    `var_ids`' device, else on `device`."""
    if var_ids is not None:
        device = var_ids.device
    else:
        device = resolve_device(device)
    col = torch.arange(n_var, device=device).view(1, 1, n_var)
    if var_ids is None:
        rows = torch.arange(n_var, device=device).view(n_var, 1, 1)
    else:
        rows = var_ids.long().view(-1, 1, 1)
    keep = col != rows
    if n_active is not None and n_active < n_var:
        keep = keep & (col < n_active) & (rows < n_active)
    return keep.to(dtype)


def init_model(generator: torch.Generator, cfg: VqVaeConfig, device=None):
    """Build (params, codebook) on `device` from `generator`: he_uniform for
    the selu layers, glorot_uniform for the sigmoid output, a
    VarianceScaling-uniform codebook, zero biases, all with the stacked fan
    semantics of `cfg.fan_mode`. The codebook is None for the naive
    quantizer."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    enc_dims, dec_dims = _layer_dims(cfg)

    def dense(i, o, init_fn):
        w = init_fn(generator, (cfg.n_var, i, o), fan_mode=cfg.fan_mode,
                    dtype=dtype, device=device)
        b = torch.zeros((cfg.n_var, 1, o), dtype=dtype, device=device)
        return (w, b)

    enc = [dense(i, o, pinit.he_uniform) for i, o in enc_dims]
    dec = []
    for li, (i, o) in enumerate(dec_dims):
        is_last = li == len(dec_dims) - 1
        init_fn = pinit.glorot_uniform if is_last else pinit.he_uniform
        dec.append(dense(i, o, init_fn))
    params = {'enc': enc, 'dec': dec}

    if cfg.quantizer == 'naive':
        codebook = None
    else:
        codebook = pinit.variance_scaling_uniform(
            generator, (cfg.n_var, cfg.dim, cfg.num_codes), scale=1.0,
            mode='fan_in', fan_mode=cfg.fan_mode, dtype=dtype, device=device)
    return params, codebook


def _dense_stack(layers, x, activation):
    """Apply a stack of batched dense layers: [n,B,i] x [n,i,o] + [n,1,o]."""
    for w, b in layers:
        x = activation(torch.baddbmm(b, x, w))
    return x


# 'auto' switches the first layer to rank1 only when the masked design's
# [n, B, n] f32 buffer would exceed this many bytes (the JAX package's rule).
FIRST_LAYER_RANK1_BYTES = 4 << 30


def _diag(w0, lo: int = 0):
    """W[..., v, lo + v, :] of a first-layer kernel [..., n, n_var, o] ->
    [..., n, o] (lo: the shard's first network)."""
    return torch.diagonal(w0, offset=lo, dim1=-3, dim2=-2).transpose(-1, -2)


def _own_inputs(y, lo: int, n: int):
    """y's columns lo .. lo + n - 1 as [..., n, B, 1]: each network's own
    variable."""
    return y.transpose(-1, -2).narrow(-2, lo, n)[..., None]


def _rank1_linear(w0, y, lo: int = 0):
    """sum_i y_i W[v,i,o] - y_v W[v,v,o]: the masked first layer's linear
    map without the [n, B, n] masked input. w0 [n, n_var, o] and y
    [B, n_var], or with a leading seed axis, w0 [S, n, n, o] and y
    [S, B, n]; network v of a shard starting at `lo` is variable lo + v."""
    if w0.dim() == 3:
        base = torch.matmul(y, w0)                                   # [n,B,o]
    else:   # one sample batch per seed: 'sbi,snio->snbo'
        base = torch.matmul(y.unsqueeze(-3), w0)                     # [S,n,B,o]
    return base - (_own_inputs(y, lo, w0.shape[-3])
                   * _diag(w0, lo)[..., None, :])


class _Rank1Linear(torch.autograd.Function):
    """`_rank1_linear` with the JAX package's custom backward
    (`_rank1_linear_bwd`): the weight gradient's diagonal W[v, v, :] is set
    to an exact zero. The base and correction terms cancel there only up to
    float residue, which Adam would amplify into drift of the inert
    diagonal; the masked path gets its exact zero from the zeroed input."""

    @staticmethod
    def forward(ctx, w0, y, lo=0):
        ctx.save_for_backward(w0, y)
        ctx.lo = lo
        return _rank1_linear(w0, y, lo)

    @staticmethod
    def backward(ctx, g):
        w0, y = ctx.saved_tensors
        lo, n = ctx.lo, w0.shape[-3]
        gw = torch.einsum('...bi,...nbo->...nio', y, g).contiguous()
        gw.diagonal(offset=lo, dim1=-3, dim2=-2).zero_()
        gy = None
        if ctx.needs_input_grad[1]:
            own = torch.einsum('...nbo,...no->...bn', g, _diag(w0, lo))
            gy = (torch.einsum('...nbo,...nio->...bi', g, w0)
                  - F.pad(own, (lo, y.shape[-1] - lo - n)))
        # one gradient an input: (w0, y) or (w0, y, lo)
        return (gw, gy, None)[:len(ctx.needs_input_grad)]


def _first_layer_rank1(w0, b0, y, act, lo: int = 0):
    """First encoder layer without materializing the [n, B, n] masked input:
    act(sum_i y_i W[v,i,o] - y_v W[v,v,o] + b), one matmul shared by all n
    networks plus a rank-1 diagonal correction."""
    return act(_Rank1Linear.apply(w0, y, lo) + b0)


def encode(params, y: torch.Tensor,
           var_ids: Optional[torch.Tensor] = None,
           activation: str = 'selu',
           first_layer: str = 'masked',
           seeds: Optional[int] = None, lo: int = 0) -> torch.Tensor:
    """Samples y [B, n_var] (or [F, B, n_var], one state per selected
    network) -> latents z [F, B, D]. Network f sees y with its own
    variable's input masked to zero. `var_ids` selects a subset of networks;
    params must already be gathered to match (see gather_variables). With
    `seeds`, y is [S, B, n_var] and params hold S stacks of n_var networks:
    z is [S * n_var, B, D]. `lo`: params hold a shard of the variable axis,
    networks lo .. lo + n_local - 1."""
    w0, b0 = params['enc'][0]
    n_var = w0.shape[1]
    act = activation_fn(activation)
    rows = var_ids
    if var_ids is None and seeds is None and (lo or w0.shape[0] != n_var):
        rows = torch.arange(lo, lo + w0.shape[0], device=y.device)
    # rank1 needs the shared-sample layout (the per-network-state [F,B,n]
    # case and explicit var_ids subsets keep the masked path)
    if var_ids is None and (y.dim() == 2 or seeds is not None) and (
            first_layer == 'rank1'
            or (first_layer == 'auto'
                and 4 * n_var * y.shape[-2] * n_var
                > FIRST_LAYER_RANK1_BYTES)):
        if seeds is None:
            x = _first_layer_rank1(w0, b0, y, act, lo)
        else:
            x = _first_layer_rank1(w0.view(seeds, n_var, *w0.shape[1:]),
                                   b0.view(seeds, n_var, *b0.shape[1:]), y,
                                   act).flatten(0, 1)
        return _dense_stack(params['enc'][1:], x, act)
    # shared float32 rows: the first layer's kernel drops each network's
    # own input as it loads the weights (no [n, B, n] masked input)
    if var_ids is None and (y.dim() == 2 or seeds is not None) and (
            y.dtype == w0.dtype == torch.float32):
        # imported here: the wrapper registers its launch counter after the
        # kernels this module's own imports load (`ops/__init__.py`)
        from pgmvae_tpu_torch.ops import cuda_first_layer
        x = act(cuda_first_layer.first_layer(w0, b0, y, seeds, lo))
        return _dense_stack(params['enc'][1:], x, act)
    mask = loo_mask(n_var, rows, y.dtype, device=y.device)
    if seeds is not None:
        x = (y[:, None] * mask).flatten(0, 1)                  # [S*n,B,n]
    else:
        x = (y[None, :, :] if y.dim() == 2 else y) * mask
    return _dense_stack(params['enc'], x, act)


def encode_codes(params, codebook, y: torch.Tensor, cfg: VqVaeConfig,
                 var_ids: Optional[torch.Tensor] = None,
                 lo: int = 0) -> torch.Tensor:
    """Encoder + quantizer only -> code indices [F, B] int32 (`lo`: params
    hold a shard of the variable axis from network lo)."""
    with torch.no_grad():
        z = encode(params, y, var_ids, cfg.activation, cfg.first_layer,
                   lo=lo)
        if cfg.quantizer == 'naive':
            return q.naive_codes(z)
        return q.vq_codes(z, codebook, impl=cfg.vq_impl)


def l2_penalty(params, seeds: Optional[int] = None) -> torch.Tensor:
    """Sum of squared dense-kernel entries (biases and codebook excluded),
    the inert diagonals included; with `seeds`, one sum per seed, [S]."""
    if seeds is not None:
        return sum(torch.sum((w * w).view(seeds, -1), 1)
                   for stack in (params['enc'], params['dec'])
                   for w, _ in stack)
    return sum(torch.sum(w * w)
               for stack in (params['enc'], params['dec'])
               for w, _ in stack)


class ForwardOut(NamedTuple):
    recon: torch.Tensor       # [n, B, n_var] sigmoid recon (diag masked)
    z: torch.Tensor           # [n, B, D] pre-quantization latents
    indices: torch.Tensor     # [n, B] code assignments
    e_loss: torch.Tensor      # commitment loss
    q_loss: torch.Tensor      # codebook loss (0 for ema/naive)


class LogitsOut(NamedTuple):
    """ForwardOut with the decoder's logits [n, B, n_var] (its last
    pre-activation, before the sigmoid) in place of recon."""
    logits: torch.Tensor
    z: torch.Tensor
    indices: torch.Tensor
    e_loss: torch.Tensor
    q_loss: torch.Tensor


def decode_logits(params, x: torch.Tensor, activation: str = 'selu'):
    """The decoder without its output sigmoid: latents [F, B, D] ->
    logits [F, B, n_var]."""
    hidden, (w, b) = params['dec'][:-1], params['dec'][-1]
    x = _dense_stack(hidden, x, activation_fn(activation))
    return torch.baddbmm(b, x, w)


def apply_model(params, codebook, y: torch.Tensor, cfg: VqVaeConfig,
                weights: Optional[torch.Tensor] = None,
                var_ids: Optional[torch.Tensor] = None,
                seeds: Optional[int] = None,
                shard: Optional[q.Shard] = None) -> ForwardOut:
    """Full forward pass: y [B, n_var] -> recon [F, B, n_var] (each
    network's own column is inert; mask it out of any loss with
    `loo_mask`). `weights` [B] (0/1 for ragged final batches) weight every
    mean of the quantizer's losses. With `seeds` (packed, y [S, B, n_var]),
    recon is [S * n_var, B, n_var] and the losses are per seed, [S]. With
    `shard` (a mesh rank's networks and rows) the losses are the rank's
    partial sums of the global means."""
    out = apply_model_logits(params, codebook, y, cfg, weights, var_ids,
                             seeds, shard)
    return ForwardOut(torch.sigmoid(out.logits), *out[1:])


def apply_model_logits(params, codebook, y: torch.Tensor, cfg: VqVaeConfig,
                       weights: Optional[torch.Tensor] = None,
                       var_ids: Optional[torch.Tensor] = None,
                       seeds: Optional[int] = None,
                       shard: Optional[q.Shard] = None) -> LogitsOut:
    """`apply_model` with the decoder's logits in place of its sigmoid
    (the trainer's loss takes them: `ops/cuda_recon.py`)."""
    z = encode(params, y, var_ids, cfg.activation, cfg.first_layer, seeds,
               lo=0 if shard is None else shard.lo)
    # with explicit var_ids the rows are selection positions, not variable
    # ids: the padding row-mask only applies to the full-stack layout
    na = (cfg.active_vars
          if var_ids is None and cfg.active_vars < cfg.n_var else None)
    if cfg.quantizer == 'naive':
        out = q.naive_forward(z, weights, n_active=na, seeds=seeds,
                              shard=shard)
        latent, indices = out.output, q.naive_codes(z.detach())
        e_loss = out.e_loss
        q_loss = torch.zeros_like(e_loss)
    else:
        latent, indices, e_loss, q_loss = q.vq_forward(
            z, codebook, weights, impl=cfg.vq_impl, n_active=na,
            seeds=seeds, shard=shard)
    return LogitsOut(decode_logits(params, latent, cfg.activation), z,
                     indices, e_loss, q_loss)


def map_params(fn, params):
    """Apply `fn` to every leaf of a params dict, keeping its layout: each
    value is a list of (w, b) layers, or one tensor (the 'vq' codebook)."""
    return {name: ([tuple(fn(p) for p in layer) for layer in value]
                   if isinstance(value, (list, tuple)) else fn(value))
            for name, value in params.items()}


def param_leaves(params) -> list:
    """The leaves of a params dict in the JAX package's flatten order: keys
    sorted, then layers, then (w, b)."""
    leaves = []
    for name in sorted(params):
        value = params[name]
        if isinstance(value, (list, tuple)):
            leaves.extend(p for layer in value for p in layer)
        else:
            leaves.append(value)
    return leaves


def params_from_leaves(like, leaves):
    """Inverse of `param_leaves`: `leaves` laid out as the params dict
    `like`."""
    it = iter(leaves)
    built = {}
    for name in sorted(like):
        value = like[name]
        if isinstance(value, (list, tuple)):
            built[name] = [tuple(next(it) for _ in layer) for layer in value]
        else:
            built[name] = next(it)
    return {name: built[name] for name in like}


def gather_variables(params, codebook, fts: torch.Tensor):
    """Select a subset of the independent networks by variable index: one
    `index_select` on axis 0 per leaf."""
    idx = fts.long()
    sub = map_params(lambda p: p.index_select(0, idx), params)
    return sub, None if codebook is None else codebook.index_select(0, idx)
