"""Stage 2: conditional probability tables from discrete codes, and
pseudo-log-likelihood (PLL) — the port of `pgmvae_tpu/stage2.py`.

  n1[v,k] = #{samples b : code_v(x_{b,-v}) = k and y[b,v] = 1}
  n0[v,k] = likewise with y[b,v] = 0
  cpt     = (n1 + 0.8) / (n1 + n0 + 1.6)
  PLL(split) = sum_{v,k} n1*log(dist+1e-5) + n0*log(1-dist+1e-5)  / N_split

where `dist` is always the CPT estimated on the train split.

The split goes to the device in pieces of whole fixed-size chunks, at
most PIECE_BYTES each (one chunk where a chunk is larger), through two
pinned host buffers (`data.pinned`): the device holds at most two pieces,
and the host makes no copy of the whole split. Only the ragged last chunk
is padded, with weight-0 rows (exact no-ops in the counts), and a padded
variable axis with zero columns; a split that fits in one piece is
uploaded once. Each chunk is one encoder pass, one nearest-code kernel
launch, and an `index_add_` of its labels at its cells (`joint_cells`).
Counts are integers < 2^24, exact in f32 under any summation order, so
they accumulate in f32 on the device and are finished in float64 on the
host, like the JAX package's (from its one-hot matmul or its scatter).

Under a device mesh (`mesh_ctx`) each data rank counts its ceil(chunk/D)
rows of every chunk with its model rank's networks; the counts are
all-reduced over 'data' (integers below 2^24: bit-equal) and gathered over
'model', so every rank holds the global tables and the CPT and PLL are
computed from them on the host exactly as on one device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.data.pinned import pinned_pieces
from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.parallel.mesh import MeshContext
from pgmvae_tpu_torch.trace import span, timed

SMOOTHING = 0.8     # reference core/model.py:88
LOG_EPS = 1e-5      # reference core/model.py:93-94
NAIVE_STAGE2_MAX_DIM = 20   # naive quantizer: 2^dim count columns; past
#                             ~1M columns the [n_var, 2^dim] tables stop
#                             being a sane tabulation
PIECE_BYTES = 64 << 20      # host-to-device piece of a split: the
#                             Trainer's stream_chunk_bytes default
MAX_COUNT_BYTES = 6 << 30   # refuse joint tables whose TWO [n_var, K*2^m]
#                             f32 count buffers exceed this


def mutual_information_matrix(y: np.ndarray) -> np.ndarray:
    """Pairwise mutual information [n, n] of binary columns, from the 2x2
    joint tables that one [n, n] matmul gives."""
    y = np.asarray(y, np.float64)
    n_samples = max(y.shape[0], 1)
    p1 = y.mean(axis=0)
    p11 = (y.T @ y) / n_samples
    p10 = np.clip(p1[:, None] - p11, 0.0, 1.0)
    p01 = np.clip(p1[None, :] - p11, 0.0, 1.0)
    p00 = np.clip(1.0 - p11 - p10 - p01, 0.0, 1.0)
    mi = np.zeros_like(p11)
    for pab, pa, pb in ((p11, p1, p1), (p10, p1, 1.0 - p1),
                        (p01, 1.0 - p1, p1), (p00, 1.0 - p1, 1.0 - p1)):
        denom = np.maximum(pa[:, None] * pb[None, :], 1e-12)
        mi += pab * (np.log(np.maximum(pab, 1e-12)) - np.log(denom))
    return mi


def select_parents(y_train: np.ndarray, m: int) -> np.ndarray:
    """Per-variable CPT parents: the m OTHER variables with the highest
    train-split mutual information with each variable, [n, m] int32. The
    CPT becomes p(y_v=1 | k, y_par) with K * 2^m tied cells per variable;
    parents are a function of x_{-v}, so the PLL stays a legal PLL."""
    mi = mutual_information_matrix(y_train)
    np.fill_diagonal(mi, -np.inf)
    order = np.argsort(-mi, axis=1)[:, :m]
    return np.ascontiguousarray(order.astype(np.int32))


def joint_cells(codes: torch.Tensor, parent_values: torch.Tensor
                ) -> torch.Tensor:
    """Each (variable, sample)'s joint-code cell, code * 2^m + the word of
    its m parents' values (bit i: parent i), int64 [n, B], from codes [n, B]
    and parent_values [n, B, m]: the counts', serving's and Gibbs' rule."""
    m = parent_values.shape[-1]
    bits = 1 << torch.arange(m, device=codes.device)
    return codes.long() * (1 << m) + (parent_values.long() * bits).sum(-1)


def auto_chunk(n_var: int, num_codes: int, budget_bytes: int = 1 << 27) -> int:
    """Chunk size bounding per-chunk device buffers (the masked input stack
    [n_var, chunk, n_var], a [n_var, chunk, K] term kept from the one-hot
    count and the widest hidden activation) to ~128 MB; 32 to 4096 rows."""
    per_row = max(1, n_var * (n_var + num_codes + 256) * 4)
    return int(max(32, min(4096, budget_bytes // per_row)))


class Stage2:
    """Counts, CPT and PLL of one model configuration on `device`. The JAX
    package's `scatter` (its count path) has no counterpart."""

    def __init__(self, cfg: vqvae.VqVaeConfig, chunk: Optional[int] = None,
                 mesh_ctx: Optional[MeshContext] = None,
                 parents: Optional[np.ndarray] = None, *, device=None):
        self.mesh = mesh_ctx or MeshContext(None)
        if device is None and self.mesh.mesh is not None:
            device = self.mesh.mesh.device
        self.device = resolve_device(device)
        self.var_range = self.mesh.var_range(cfg.n_var)
        self.cfg = cfg
        self.k = cfg.effective_codes
        if cfg.quantizer == 'naive' and cfg.dim > NAIVE_STAGE2_MAX_DIM:
            raise ValueError(
                f"quantizer='naive' counts over 2^dim = 2**{cfg.dim} stage-2 "
                f"code columns per variable; dim > {NAIVE_STAGE2_MAX_DIM} "
                f"cannot be tabulated (use dim <= {NAIVE_STAGE2_MAX_DIM} or "
                f"a finite-codebook quantizer)")
        # joint-code CPTs: condition each variable's table on its code AND
        # the observed values of `parents` [active_vars, m] partner
        # variables (see select_parents) -> counts become [n, K, 2^m]
        self.parents = None
        self.n_states = 1
        if parents is not None and parents.size:
            parents = np.asarray(parents, np.int32)
            m = parents.shape[1]
            if not 0 < m <= 12:    # 2^m multiplies every count buffer
                raise ValueError(f'cpt parents per variable must be in '
                                 f'[1, 12], got {m}')
            if parents.shape[0] < cfg.n_var:     # padded variable axis:
                parents = np.pad(                # inert rows point at var 0
                    parents,
                    ((0, cfg.n_var - parents.shape[0]), (0, 0)))
            self.parents = torch.as_tensor(parents, dtype=torch.long,
                                           device=self.device)
            self.n_states = 1 << m
        cols = self.k * self.n_states
        if 2 * cfg.n_var * cols * 4 > MAX_COUNT_BYTES:
            raise ValueError(
                f'joint-code CPT needs two [n_var={cfg.n_var}, '
                f'K*2^m={cols}] f32 count buffers '
                f'({2 * cfg.n_var * cols * 4 / 2**30:.1f} GiB) — past the '
                f'{MAX_COUNT_BYTES / 2**30:.0f} GiB budget; '
                f'use fewer parents or a smaller codebook')
        self.chunk = int(chunk or auto_chunk(cfg.n_var, self.k))

    def _count_chunk(self, params, codebook, n1, n0, yb, wb):
        """One fixed-shape chunk: yb [chunk, n_var], wb [chunk] validity
        weights (0 on padded rows); adds into n1/n0 [n_var, K * n_states]
        in place."""
        lo, hi = self.var_range
        codes = vqvae.encode_codes(params, codebook, yb, self.cfg,
                                   lo=lo).long()               # [n, B]
        if self.parents is not None:
            codes = joint_cells(
                codes, yb[:, self.parents[lo:hi]].transpose(0, 1))
        y1 = yb.T[lo:hi] * wb[None, :]                         # [n, B]
        y0 = (1.0 - yb.T[lo:hi]) * wb[None, :]
        rows = torch.arange(hi - lo, device=yb.device)[:, None]
        flat = (rows * n1.shape[1] + codes).reshape(-1)
        n1.view(-1).index_add_(0, flat, y1.reshape(-1))
        n0.view(-1).index_add_(0, flat, y0.reshape(-1))

    def counts(self, params, codebook, y_host: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Dataset code/label co-occurrence counts as float64
        [active_vars, K] ([active_vars, K, 2^m] with parents). Accepts
        true-width samples when the model's variable axis is padded."""
        cfg, chunk, mesh = self.cfg, self.chunk, self.mesh
        y = np.asarray(y_host)
        n, width = y.shape
        chunks = max(1, -(-n // chunk))
        per_piece = min(chunks, max(1, PIECE_BYTES // (chunk * cfg.n_var
                                                       * 4)))
        rows = per_piece * chunk

        def fill(p, buf):
            """Piece p's rows into buf [rows, n_var]; the ragged last chunk
            padded with zero rows (the columns past `width` stay zero)."""
            lo = p * rows
            m = max(0, min(rows, n - lo))
            host = buf.numpy()
            host[:m, :width] = y[lo:lo + m]
            padded = max(1, -(-m // chunk)) * chunk
            host[m:padded] = 0.0
            return buf[:padded]
        cols = self.k * self.n_states
        lo, hi = self.var_range
        n1 = torch.zeros((hi - lo, cols), dtype=torch.float32,
                         device=self.device)
        n0 = torch.zeros_like(n1)
        pieces = pinned_pieces(-(-chunks // per_piece), (rows, cfg.n_var),
                               torch.float32, self.device, fill)
        with torch.no_grad():
            for p, yd in enumerate(pieces):
                # weight 1 on the split's rows, 0 on the padding
                wd = (torch.arange(yd.shape[0], device=self.device)
                      < n - p * rows).to(torch.float32)
                for start in range(0, yd.shape[0], chunk):
                    # this data rank's rows of the chunk
                    with span('stage2.chunk'):
                        self._count_chunk(
                            params, codebook, n1, n0,
                            mesh.local_rows(yd[start:start + chunk]),
                            mesh.local_rows(wd[start:start + chunk]))
            if mesh.mesh is not None:
                n1, n0 = mesh.all_reduce_many((n1, n0), 'data')
                n1 = mesh.all_gather(n1, 'model')
                n0 = mesh.all_gather(n0, 'model')
        na = cfg.active_vars                # padding networks sliced away
        n1 = n1.cpu().numpy().astype(np.float64)[:na]
        n0 = n0.cpu().numpy().astype(np.float64)[:na]
        if self.parents is not None:        # [na, K, 2^m] joint-code tables
            n1 = n1.reshape(na, self.k, self.n_states)
            n0 = n0.reshape(na, self.k, self.n_states)
        return n1, n0

    def cpt(self, params, codebook, y_train: np.ndarray) -> np.ndarray:
        """Smoothed conditional probability table p(y_v=1 | code=k),
        float64 [n_var, K]. Host span and counter: `stage2.cpt`
        (`trace.timed`), with a `stage2.chunk` span a chunk."""
        with timed('stage2.cpt'):
            n1, n0 = self.counts(params, codebook, y_train)
            return (n1 + SMOOTHING) / (n1 + n0 + 2 * SMOOTHING)

    def pseudo_log_likelihood(self, params, codebook, y_host: np.ndarray,
                              dist: np.ndarray) -> float:
        """Average per-sample PLL of a split under `dist` (counts from this
        split, `dist` from train)."""
        return self.pll_detail(params, codebook, y_host, dist)[0]

    def pll_detail(self, params, codebook, y_host: np.ndarray,
                   dist: np.ndarray) -> Tuple[float, np.ndarray]:
        """(split PLL, per-variable contributions [active_vars] float64);
        the scalar is the vector's sum."""
        n1, n0 = self.counts(params, codebook, y_host)
        lp1 = np.log(dist + LOG_EPS)
        lp0 = np.log(1.0 - dist + LOG_EPS)
        terms = n1 * lp1 + n0 * lp0
        per_var = terms.reshape(terms.shape[0], -1).sum(1) / y_host.shape[0]
        return float(per_var.sum()), per_var


def compose_mixed_cpt(dists: dict, parents_by_m: dict, sel_ms
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Compose per-variable winner tables (one M per variable) into ONE
    uniform-width joint-code CPT [n, K, 2^m_max] with parents [n, m_max];
    (dists[0], None) when every variable chose m == 0.

    Exact: each variable's [K, 2^m] block is tiled along the word axis, so
    entry [k, w] = original [k, w mod 2^m]; the low m bits are the
    variable's own parent word and the padding slots never change the
    looked-up value."""
    sel_ms = np.asarray(sel_ms, np.int32)
    n = sel_ms.shape[0]
    m_max = int(sel_ms.max(initial=0))
    if m_max == 0:
        return np.asarray(dists[0], np.float64), None
    k = next(iter(dists.values())).shape[1]
    dist = np.empty((n, k, 1 << m_max), np.float64)
    parents = np.zeros((n, m_max), np.int32)
    for v in range(n):
        m = int(sel_ms[v])
        tab = np.asarray(dists[m][v], np.float64).reshape(k, -1)  # [K, 2^m]
        dist[v] = np.tile(tab, (1, (1 << m_max) >> m))
        if m:
            parents[v, :m] = parents_by_m[m][v, :m]
        if m < m_max:           # inert slots: any non-self variable works
            parents[v, m:] = 0 if v != 0 else 1
    return dist, parents
