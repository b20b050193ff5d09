"""Checkpoints in the JAX package's file format (the port of
`pgmvae_tpu/checkpoint.py`), so each package reads the other's files.

A file is the magic `PGMVAE1\\n`, an 8-byte little-endian header length, a
JSON header `{'config': cfg._asdict(), 'has_dist', 'extra'}`, and a msgpack
payload `{'dist'?, 'state'}` in flax's state-dict layout, written by the
port's own codec (`utils/msgpack.py`):

- every map's keys are sorted (flax's writer passes the tree through
  `jax.tree.map`, which sorts them); a list becomes `{'0': ..., '1': ...}`;
  `None` is nil and optax's empty states are `{}`;
- an array is extension type 1 holding `packb((shape, dtype name, bytes))`;
  one of more than MAX_CHUNK_SIZE bytes becomes `{'__msgpack_chunked_array__':
  True, 'shape': ..., 'chunks': ...}` of flat pieces;
- the train state is `{'ema', 'opt_state', 'params', 'step'}`, the optimizer
  state optax's `inject_hyperparams(adam)` layout: `{'count', 'hyperparams':
  {'b1', 'b2', 'eps', 'eps_root', 'learning_rate'}, 'hyperparams_states':
  {}, 'inner_state': {'0': {'count', 'mu', 'nu'}, '1': {}}}`, scalars as
  0-d float32 or int32 arrays.

The Adam kernel takes b1=0.9, b2=0.999 and eps_root=0 only: the writer
stores those and the reader refuses other values. optax's own update
advances the outer `count` with the inner one, the JAX package's fused
updates leave it where it was; nothing reads it, the reader ignores it and
the writer stores the step count there. `bfloat16` moments (adam_impl
'fused_bf16') are read as 16-bit words and viewed as `torch.bfloat16`.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from pgmvae_tpu_torch.models.vqvae import VqVaeConfig
from pgmvae_tpu_torch.ops.fused_adam import AdamState
from pgmvae_tpu_torch.ops.quantizer import EmaState
from pgmvae_tpu_torch.train import TrainState
from pgmvae_tpu_torch.utils import msgpack

_MAGIC = b'PGMVAE1\n'
MAX_CHUNK_SIZE = 2 ** 30     # flax.serialization's: larger arrays are chunked
_NDARRAY = 1                 # flax's extension type code of an array
_CHUNKED = '__msgpack_chunked_array__'
# the hyperparameters the Adam kernel takes (ops/fused_adam.py)
ADAM_CONSTANTS = {'b1': 0.9, 'b2': 0.999, 'eps_root': 0.0}


def _host(x) -> Tuple[np.ndarray, str]:
    """A leaf as (C-ordered numpy array of its bytes' type, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), 'bfloat16'
        x = x.numpy()
    x = np.asarray(x, order='C')
    return x, x.dtype.name


def _array_ext(arr: np.ndarray, name: str) -> msgpack.ExtType:
    raw = memoryview(arr.reshape(-1).view(np.uint8))
    return msgpack.ExtType(_NDARRAY, msgpack.pack_parts(
        (list(arr.shape), name, raw)))


def _encode(tree) -> Any:
    """A state dict of leaves -> what the codec packs: maps sorted, arrays
    as extension values or chunk maps, as flax writes them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _encode(tree[key]) for key in sorted(tree)}
    arr, name = _host(tree)
    if arr.size * arr.dtype.itemsize <= MAX_CHUNK_SIZE:
        return _array_ext(arr, name)
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            'shape': {str(i): int(d) for i, d in enumerate(arr.shape)},
            'chunks': {str(i): _array_ext(c, name)
                       for i, c in enumerate(chunks)}}


def _params_dict(params: dict) -> dict:
    """The params layout as flax's state dict: lists and (w, b) tuples
    become maps keyed '0', '1', ..."""
    return {name: ({str(i): {str(j): p for j, p in enumerate(layer)}
                    for i, layer in enumerate(value)}
                   if isinstance(value, (list, tuple)) else value)
            for name, value in params.items()}


def state_dict(state: TrainState) -> dict:
    """A port TrainState as the JAX TrainState's flax state dict (leaves
    stay tensors)."""
    opt = state.opt_state

    def f32(x):
        return np.asarray(x, np.float32)

    return {
        'params': _params_dict(state.params),
        'ema': None if state.ema is None else state.ema._asdict(),
        'opt_state': {
            'count': opt.count,
            'hyperparams': {**{k: f32(v) for k, v in ADAM_CONSTANTS.items()},
                            'eps': f32(opt.eps),
                            'learning_rate': opt.learning_rate},
            'hyperparams_states': {},
            'inner_state': {'0': {'count': opt.count,
                                  'mu': _params_dict(opt.mu),
                                  'nu': _params_dict(opt.nu)},
                            '1': {}}},
        'step': state.step,
    }


def save(path: str, cfg: VqVaeConfig, state, dist: Optional[np.ndarray] = None,
         extra: Optional[dict] = None) -> None:
    """Atomically write {config, train state, optional CPT, metadata}.
    `state` is a port TrainState, or a raw state dict as `load` returns
    it without a template."""
    tree = state_dict(state) if isinstance(state, TrainState) else state
    payload = {'state': tree}
    if dist is not None:
        payload['dist'] = np.asarray(dist)
    header = json.dumps({
        'config': cfg._asdict(),
        'has_dist': dist is not None,
        'extra': extra or {},
    }).encode()
    parts = msgpack.pack_parts(_encode(payload))
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=parent)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(_MAGIC)
            f.write(len(header).to_bytes(8, 'little'))
            f.write(header)
            for part in parts:
                f.write(part)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _ext_hook(code: int, data: bytes):
    if code != _NDARRAY:
        return msgpack.ExtType(code, data)
    shape, name, buf = msgpack.unpackb(data)
    if name == 'bfloat16':       # no numpy dtype without ml_dtypes
        words = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def params_from_state(tree: dict) -> dict:
    """A raw params state dict (from `load` without a template) in the
    port's params layout, as CPU tensors."""
    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x))

    return {name: ([tuple(tensor(value[str(i)][str(j)])
                          for j in range(len(value[str(i)])))
                    for i in range(len(value))]
                   if isinstance(value, dict) else tensor(value))
            for name, value in tree.items()}


def _keys(sd, like, where: str) -> None:
    if not isinstance(sd, dict) or set(sd) != set(like):
        got = sorted(sd) if isinstance(sd, dict) else type(sd).__name__
        raise ValueError(f'checkpoint state at {where} holds {got}, the '
                         f'template {sorted(like)}')


def _restore(template: TrainState, sd: dict) -> TrainState:
    """The raw state dict `sd` in the structure of the port TrainState
    `template`, as tensors on the template's device (values, shapes and
    dtypes are the file's, as flax's `from_state_dict` takes them)."""
    device = template.step.device

    def tensor(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return x.to(device)

    def params(like: dict, tree, where: str) -> dict:
        _keys(tree, like, where)
        out = {}
        for name, value in like.items():
            if isinstance(value, (list, tuple)):
                _keys(tree[name], [str(i) for i in range(len(value))],
                      f'{where}/{name}')
                out[name] = [tuple(tensor(tree[name][str(i)][str(j)])
                                   for j in range(len(layer)))
                             for i, layer in enumerate(value)]
            else:
                out[name] = tensor(tree[name])
        return out

    _keys(sd, ('ema', 'opt_state', 'params', 'step'), 'state')
    opt = sd['opt_state']
    hp = opt['hyperparams']
    for name, value in ADAM_CONSTANTS.items():
        if float(hp[name]) != float(np.float32(value)):
            raise ValueError(f'checkpoint Adam {name}={float(hp[name])}: the '
                             f'Adam kernel takes {name}={value} only')
    inner = opt['inner_state']['0']
    ema = None
    if template.ema is not None:
        _keys(sd['ema'], EmaState._fields, 'state/ema')
        ema = EmaState(**{f: tensor(sd['ema'][f]) for f in EmaState._fields})
    elif sd['ema'] is not None:
        raise ValueError('checkpoint state holds an EMA codebook state; the '
                         'template has none')
    opt_state = AdamState(
        count=tensor(inner['count']),
        mu=params(template.opt_state.mu, inner['mu'], 'state/opt_state/mu'),
        nu=params(template.opt_state.nu, inner['nu'], 'state/opt_state/nu'),
        learning_rate=tensor(hp['learning_rate']),
        eps=float(np.float32(hp['eps'])))
    return TrainState(params(template.params, sd['params'], 'state/params'),
                      ema, opt_state, tensor(sd['step']))


def load(path: str, state_template: Optional[TrainState] = None
         ) -> Tuple[VqVaeConfig, Any, Optional[np.ndarray], dict]:
    """Read a checkpoint: (config, state, dist or None, extra). With
    `state_template` (a port TrainState, e.g. from `Trainer.init_state`) the
    state is restored into that structure, as tensors on its device;
    otherwise the raw nested dict is returned, with numpy leaves
    (`torch.bfloat16` CPU tensors for bfloat16 arrays), enough for
    inference-only uses."""
    with open(path, 'rb') as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f'not a pgmvae checkpoint: {path}')
        hlen = int.from_bytes(f.read(8), 'little')
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    cfg_d = header['config']
    cfg_d['units'] = tuple(cfg_d['units'])
    cfg = VqVaeConfig(**cfg_d)

    payload = _unchunk(msgpack.unpackb(blob, ext_hook=_ext_hook))
    state = payload['state']
    if state_template is not None:
        state = _restore(state_template, state)
    dist = payload.get('dist') if header['has_dist'] else None
    return cfg, state, dist, header['extra']
