"""The device mesh over `torch.distributed` (the port of
`pgmvae_tpu/parallel/mesh.py`).

One process per rank. A ('data', 'model') mesh of D x M ranks places rank r
at (r // M, r % M), as the JAX package's `reshape(data, model)` does, and
gives each axis its own process groups:

- `data`: the batch. Data rank d takes the contiguous rows
  [d * ceil(B/D), (d+1) * ceil(B/D)) of every global batch (rows past B
  carry weight 0, so every sum stays exact). Gradients, EMA statistics and
  stage-2 counts are all-reduced over the D ranks that hold the same
  networks before they are used, which keeps the mesh's updates those of
  one device.
- `model`: the stacked variable axis. Model rank m holds networks
  [m * n_var/M, (m+1) * n_var/M) of every leaf whose leading dimension is
  n_var (kernels, biases, codebook, EMA state, Adam moments); scalars are
  replicated. The networks are independent, so only the losses' partial
  sums, the metrics and gathers for restarts, checkpoints and the CMLL
  cross this axis.

`MeshContext(None)` makes every operation a no-op, so single-device code
runs the same path unchanged.

Backend: NCCL when every rank has a GPU of its own; gloo when ranks share
one GPU (NCCL refuses two ranks on one device) and on the CPU. The context
records which (`describe()`). The port uses only the collectives gloo takes
on CUDA tensors: `all_reduce`, `all_gather` and `broadcast`. gloo's
collectives cannot be captured into a CUDA graph, so under gloo the train
step runs eagerly (`MeshContext.captures`).

`spawn(fn, args, world_size, device)` runs `fn(device, *args)` in one
process per rank (`torch.multiprocessing.start_processes`, 'spawn'), after
building the CUDA kernels once in the caller. The ranks meet through a
`file://` store in a temporary directory (no TCP port to collide), a world
that outlives `timeout` is terminated and raises, and an exception in a
rank is raised in the caller. Each rank's return value and kernel launch
counts come back to the caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from pgmvae_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh of this process's world: its shape, this
    rank, the backend, this rank's device and the process group of each
    axis that holds this rank ('world' holds every rank)."""
    shape: tuple
    rank: int
    backend: str
    device: torch.device
    groups: dict


def in_world() -> bool:
    """Whether this process is a rank of an initialised world."""
    return dist.is_available() and dist.is_initialized()


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The (data, model) mesh of the initialised world: `data=-1` takes
    every rank left. Every rank must call it, in the same order as its
    other group creations. `device` is this rank's; None means CUDA (device
    rank % count under NCCL, the current CUDA device under gloo) and raises
    without it."""
    if not in_world():
        raise RuntimeError('make_mesh needs a torch.distributed world: run '
                           'under parallel.spawn or torchrun')
    world = dist.get_world_size()
    if data == -1:
        if world % model:
            raise ValueError(f'{world} ranks do not split into model={model}')
        data = world // model
    if data * model != world:
        raise ValueError(f'a ({data}, {model}) mesh needs {data * model} '
                         f'ranks; the world has {world}')
    rank, backend = dist.get_rank(), str(dist.get_backend())
    # every rank creates every group, in one order
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    d, m = divmod(rank, model)
    if device is None:
        resolve_device(None)                   # raises without CUDA
        device = torch.device('cuda', rank % torch.cuda.device_count()
                              if backend == 'nccl'
                              else torch.cuda.current_device())
    return Mesh((data, model), rank, backend, torch.device(device),
                {'data': data_groups[m], 'model': model_groups[d],
                 'world': dist.group.WORLD})


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The (optional) mesh and the operations the port needs on it. With
    `mesh=None` every operation is a no-op: one device runs the same
    path."""
    mesh: Optional[Mesh] = None

    @property
    def shape(self) -> tuple:
        return (1, 1) if self.mesh is None else self.mesh.shape

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape[1]

    @property
    def captures(self) -> bool:
        """Whether a step with this mesh's collectives can be captured into
        a CUDA graph: no mesh, or NCCL."""
        return self.mesh is None or self.mesh.backend == 'nccl'

    def describe(self) -> Optional[dict]:
        if self.mesh is None:
            return None
        return {'shape': list(self.shape), 'backend': self.mesh.backend,
                'device': str(self.mesh.device)}

    # ---------------------------------------------------------- layout --
    def var_range(self, n_var: int) -> tuple:
        """This rank's networks [lo, hi) of a stacked axis of n_var."""
        m = self.shape[1]
        if n_var % m:
            raise ValueError(f'n_var={n_var} does not split over model={m}: '
                             f'pad the variable axis (VqVaeConfig.n_active)')
        per = n_var // m
        return self.model_rank * per, (self.model_rank + 1) * per

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's ceil(B/D) contiguous rows of a global batch x
        [B, ...], zero rows past B."""
        if self.mesh is None:
            return x
        per = -(-x.shape[0] // self.shape[0])
        return self.padded_rows(x)[self.data_rank * per:
                                   (self.data_rank + 1) * per]

    def padded_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ...] with zero rows appended up to D * ceil(B/D)."""
        d = self.shape[0]
        pad = -(-x.shape[0] // d) * d - x.shape[0]
        if not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    def put(self, x, axis: Optional[str] = None) -> torch.Tensor:
        """A host array on this rank's device: the rank's shard of axis 0
        over the mesh `axis` ('model': its networks, 'data': its batch
        rows), or the whole array (None)."""
        t = torch.as_tensor(x)
        if self.mesh is not None:
            if axis == 'model':
                lo, hi = self.var_range(t.shape[0])
                t = t[lo:hi]
            elif axis == 'data':
                t = self.local_rows(t)
        device = None if self.mesh is None else self.mesh.device
        return t.to(device) if device is not None else t

    # ----------------------------------------------------- collectives --
    def _group(self, axis: str):
        return self.mesh.groups[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = 'world'
                   ) -> torch.Tensor:
        """Sum of t over `axis` ('data', 'model' or 'world'), in place."""
        if self.mesh is not None:
            dist.all_reduce(t, group=self._group(axis))
        return t

    def all_reduce_many(self, tensors: Sequence[torch.Tensor],
                        axis: str = 'world') -> list:
        """`all_reduce` of several float tensors as one collective; returns
        the summed tensors (new ones under a mesh)."""
        tensors = list(tensors)
        if self.mesh is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self._group(axis))
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' t along `axis`, concatenated on `dim` in rank order."""
        if self.mesh is None:
            return t
        group = self._group(axis)
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s t on every rank, in place."""
        if self.mesh is not None:
            dist.broadcast(t, src, group=self._group('world'))
        return t

    def on_rank0(self, fn: Callable[[], float]) -> float:
        """fn() run on rank 0 only; every rank gets its float value (the
        others wait in the broadcast)."""
        if self.mesh is None:
            return fn()
        value = torch.zeros((), dtype=torch.float64, device=self.mesh.device)
        if self.rank == 0:
            value.fill_(float(fn()))
        return float(self.broadcast(value))


def shard_leading_axis(n_var: int) -> Callable[[object], bool]:
    """Sharding rule for state trees: whether a leaf is split over 'model'
    (its leading dimension is n_var); every other leaf is replicated."""
    def rule(leaf) -> bool:
        return (hasattr(leaf, 'ndim') and leaf.ndim >= 1
                and leaf.shape[0] == n_var)
    return rule


# ------------------------------------------------------------- spawn --

class RankResult(NamedTuple):
    value: object            # what fn returned on this rank
    launches: dict           # the rank's kernel launch counts, by name
    device: str


def placement(world_size: int, device) -> tuple:
    """(backend, the ranks' devices) for a world of `world_size` ranks on
    `device`'s kind: NCCL with a GPU for each rank when there are enough,
    gloo with every rank on `device` otherwise."""
    device = torch.device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', device.index or 0)
        if torch.cuda.device_count() >= world_size:
            return 'nccl', [f'cuda:{r}' for r in range(world_size)]
        return 'gloo', [str(device)] * world_size
    return 'gloo', [str(device)] * world_size


def build_kernels() -> None:
    """Build every registered kernel library (`ops/kernels.py`; one nvcc
    each, together), so that the ranks only load them."""
    from pgmvae_tpu_torch.ops import kernels
    builds = kernels.builds().values()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(build) for build in builds]:
            f.result()


def _rank_main(rank: int, payload: bytes, world_size: int, backend: str,
               devices: list, store: str, out_dir: str,
               collective_timeout: float) -> None:
    from pgmvae_tpu_torch.ops import kernels
    fn, args = pickle.loads(payload)
    # one CPU thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f'file://{store}', world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=collective_timeout))
    try:
        value = fn(device, *args)
        launches = kernels.counts()
        with open(os.path.join(out_dir, f'rank-{rank}.pkl'), 'wb') as f:
            pickle.dump(RankResult(value, launches, str(device)), f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, args: tuple = (), world_size: int = 1, device=None,
          timeout: Optional[float] = None,
          collective_timeout: float = 7200.0) -> list:
    """Run `fn(device, *args)` in `world_size` fresh processes, one a rank
    of a new world (`placement` picks the backend and devices), and return
    each rank's `RankResult`, in rank order. `device` None means CUDA and
    raises without it. `fn` must be a module-level
    function and `args` picklable; each rank gets its own copy of them (by
    value: torch.multiprocessing would hand the ranks one shared-memory
    tensor, which in-place updates of several ranks would each change). A
    rank's exception is raised here; a
    world that runs past `timeout` seconds is terminated and raises
    TimeoutError; a collective that waits past `collective_timeout`
    seconds fails its rank."""
    device = resolve_device(device)
    backend, devices = placement(world_size, device)
    if device.type == 'cuda':
        build_kernels()
    tmp = tempfile.mkdtemp(prefix='pgmvae-mesh-')
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(pickle.dumps((fn, args)), world_size,
                              backend, devices,
                              os.path.join(tmp, 'store'), tmp,
                              collective_timeout),
            nprocs=world_size, join=False, start_method='spawn')
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5.0 if deadline is None else
                               max(0.0, min(5.0, deadline - time.monotonic()))):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f'a world of {world_size} ranks ran '
                                       f'past {timeout} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f'rank-{r}.pkl'), 'rb') as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def summed_launches(results: Sequence[RankResult]) -> dict:
    """The ranks' kernel launch counts, summed by kernel."""
    out = {}
    for r in results:
        for name, n in r.launches.items():
            out[name] = out.get(name, 0) + n
    return out
