"""The model conditional p(y_v = 1 | rest) that serving and Gibbs sampling
read, and the conditional-marginal log-likelihood (CMLL) by blockwise Gibbs
sampling (the port of `pgmvae_tpu/gibbs.py`, reference
`core/model.py:98-148`).

- The n variables are cut into `blocks = ceil(n / p1)` blocks of p1
  (the last one possibly smaller). Each block runs its own chain over a
  copy of the test batch: the chain state is [blocks, B, n_var], padded
  columns included.
- At step i, block b resamples variable `b*p1 + (i mod vol_b)` from the
  model conditional given the chain's current state: one `get_probability`
  over the blocks' variables, i.e. one encoder pass and one launch of the
  nearest-code kernel.
- Steps i > burn_in*p1 (strictly) add the sampled values into the counts;
  CMLL is the Bernoulli log-likelihood of the data under the counts'
  marginals, in float32 with LOG_EPS. The last (ragged) block's counts are
  normalised by `floor(valid * p1 / vol_last)`, the reference's floor
  division, kept so that values stay comparable.

The step is one body over static buffers, the counterpart of the JAX
package's `_cmll_segment` (`lax.fori_loop`): a device step counter i takes
the place of the loop index, steps count their draws multiplied by a 0/1
flag (i > burn_in*p1), and the uniforms [blocks, B] of step i are row j of a
static buffer [G, blocks, B] filled once every sub-segment of G steps (G
keeps the buffer within UNIFORM_BYTES). On CUDA the first step runs eagerly
and the body is captured into a CUDA graph, which every later step replays
(`graphs.StepGraph`); on the CPU, or with `graphs=False`, the body runs in a
Python loop. No step reads the device: the counts stay there until the end.

`run(start, steps, uniform)` fills the buffer from `uniform(i)`, so a test
can feed the JAX package's `uniform(fold_in(key, i), (blocks, B))` through
the same body; the public function fills it with one draw of [G, blocks, B]
from a `torch.Generator` a sub-segment.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from pgmvae_tpu_torch import graphs as pgraphs
from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.stage2 import joint_cells
from pgmvae_tpu_torch.trace import span

LOG_EPS = 1e-5          # reference core/model.py:148
SEGMENT_STEPS = 8192    # steps between progress lines (the JAX package's
#                         segment: one device execution there)
UNIFORM_BYTES = 256 << 20   # bound on the static uniform buffer


def get_probability(params, codebook, cfg, dist, y, fts, parents=None):
    """p(y_v = 1 | code_v(y_{-v})[, y_parents(v)]) for the selected
    variables, [n_sel, B].

    y: full-width samples — [B, n_var] shared across selections, or
    [n_sel, B, n_var] one state per selection. Each selected network masks
    its own variable internally. fts: [n_sel] variable ids. `dist` is the
    CPT as a tensor: [n, K], or [n, K, 2^m] with `parents` [n, m], whose
    lookup also keys on the binary word of the sample's values at the
    selected variable's parents."""
    fts = fts.long()
    sub_params, sub_codebook = vqvae.gather_variables(params, codebook, fts)
    codes = vqvae.encode_codes(sub_params, sub_codebook, y, cfg,
                               var_ids=fts).long()                # [n_sel,B]
    if parents is None:
        prb = dist.index_select(0, fts)                           # [n_sel,K]
        return torch.gather(prb, 1, codes)
    par = parents.long().index_select(0, fts)                     # [n_sel,m]
    if y.dim() == 2:
        vals = y[:, par].permute(1, 0, 2)                         # [n_sel,B,m]
    else:
        vals = torch.gather(y, 2, par[:, None, :].expand(-1, y.shape[1], -1))
    prb = dist.reshape(dist.shape[0], -1).index_select(0, fts)    # [n_sel,K*2^m]
    return torch.gather(prb, 1, joint_cells(codes, vals))


class GibbsChain:
    """The blockwise chain over a test batch x [B, n] on the params'
    device: `state` [blocks, B, n_var] and `counts` [B, n], both float32,
    updated in place by the step body. On CUDA the body is replayed as a
    captured graph unless `graphs` is False."""

    def __init__(self, params, codebook, cfg: vqvae.VqVaeConfig, dist, x,
                 p1: int, burn_in: int, parents=None, graphs: bool = True):
        self.device = vqvae.param_leaves(params)[0].device
        self.params, self.codebook, self.cfg = params, codebook, cfg
        self.p1, self.burn_in = int(p1), int(burn_in)
        self.dist = torch.as_tensor(np.asarray(dist, np.float32),
                                    device=self.device)
        self.parents = (None if parents is None else torch.as_tensor(
            np.asarray(parents, np.int64), device=self.device))
        self.x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        batch, n = self.x.shape
        self.blocks = math.ceil(n / self.p1)
        self.vol_last = n - self.p1 * (self.blocks - 1)
        state = self.x.expand(self.blocks, batch, n)
        if cfg.n_var > n:                   # padded variable axis: append
            state = torch.cat([state, torch.zeros(  # inert zero columns
                (self.blocks, batch, cfg.n_var - n), device=self.device)], -1)
        self.state = state.contiguous()
        self.counts = torch.zeros((batch, n), device=self.device)
        self.marker = torch.arange(self.blocks, device=self.device) * self.p1
        self.vol = torch.full((self.blocks,), self.p1, device=self.device)
        self.vol[-1] = self.vol_last
        # the step counter i, the position j in the uniform buffer, and the
        # buffer of G steps' uniforms
        self.i = torch.zeros((), dtype=torch.int64, device=self.device)
        self.j = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.sub_steps = max(1, min(SEGMENT_STEPS, UNIFORM_BYTES
                                    // (4 * self.blocks * batch)))
        self.u = torch.empty((self.sub_steps, self.blocks, batch),
                             device=self.device)
        self.graph = pgraphs.StepGraph(
            lambda generators: self._step(), self.device,
            capture=graphs and self.device.type == 'cuda')

    def _step(self) -> None:
        """Gibbs step i with the uniforms u[j]: block b resamples variable
        marker_b + i mod vol_b; steps past burn_in*p1 count."""
        y = self.marker + torch.remainder(self.i, self.vol)   # [blocks]
        prb = get_probability(self.params, self.codebook, self.cfg,
                              self.dist, self.state, y, parents=self.parents)
        u = self.u.index_select(0, self.j)[0]                 # [blocks, B]
        gibbs = (u < prb).to(self.state.dtype)
        self.state.scatter_(
            2, y.view(-1, 1, 1).expand(-1, self.state.shape[1], 1),
            gibbs[:, :, None])
        # strict >, ref core/model.py:139; a 0/1 flag, as the JAX package's
        # segment counts
        flag = (self.i > self.burn_in * self.p1).to(self.counts.dtype)
        self.counts.index_add_(1, y, gibbs.T * flag)
        self.i.add_(1)
        self.j.add_(1)

    def _run(self, start: int, steps: int, fill) -> None:
        """Steps start .. start+steps-1, in sub-segments of at most G steps:
        `fill(i0, g)` writes the uniforms of steps i0 .. i0+g-1 into
        u[:g], then the body runs g times. Host spans: `gibbs.run`, and in
        it `gibbs.fill` a sub-segment."""
        with span('gibbs.run'), torch.no_grad():
            self.i.fill_(start)
            done = 0
            while done < steps:
                g = min(self.sub_steps, steps - done)
                with span('gibbs.fill'):
                    fill(start + done, g)
                self.j.zero_()
                self.graph.run(g)
                done += g

    def run(self, start: int, steps: int,
            uniform: Callable[[int], torch.Tensor]) -> None:
        """Steps start .. start+steps-1, step i with uniforms `uniform(i)`
        [blocks, B]."""
        self._run(start, steps, self._filler(uniform))

    def _filler(self, uniform: Callable[[int], torch.Tensor]):
        """A `fill` that copies `uniform(i)` into the buffer, step by step."""
        def fill(i0: int, g: int) -> None:
            for k in range(g):
                self.u[k].copy_(uniform(i0 + k))
        return fill

    def _sample(self, num_smp: int, fill, verbose: bool) -> float:
        total, done = int(num_smp) * self.p1, 0
        while done < total:
            seg = min(SEGMENT_STEPS, total - done)
            self._run(done, seg, fill)
            done += seg
            if verbose:
                # sampling progress, as the reference prints it under
                # `verbose` (reference core/model.py:141-142)
                print(f'cmll sampling step {done}/{total}', flush=True)
        return self.cmll(num_smp)

    def sample(self, num_smp: int, uniform: Callable[[int], torch.Tensor],
               verbose: bool = False) -> float:
        """Run the whole chain (num_smp * p1 steps from step 0), step i with
        uniforms `uniform(i)`, and return its CMLL. `verbose` prints
        progress every SEGMENT_STEPS steps."""
        return self._sample(num_smp, self._filler(uniform), verbose)

    def sample_from(self, num_smp: int, generator: torch.Generator,
                    verbose: bool = False) -> float:
        """`sample` with the uniforms drawn from `generator` (on the
        chain's device): one draw of [G, blocks, B] a sub-segment of G
        steps (`sub_steps`), not one a step."""
        def fill(i0: int, g: int) -> None:
            torch.rand((g, self.blocks, self.x.shape[0]), generator=generator,
                       out=self.u[:g])
        return self._sample(num_smp, fill, verbose)

    def release(self) -> None:
        """Release the captured step graph and its memory pool."""
        self.graph.release()

    def cmll(self, num_smp: int) -> float:
        """The CMLL of the counts so far, as if num_smp sweeps had run."""
        batch, n = self.counts.shape
        valid = float(int(num_smp) - self.burn_in)
        valid_end = float(int(valid * self.p1) // self.vol_last)
        denom = torch.full((1, n), valid, device=self.device)
        denom[:, n - self.vol_last:] = valid_end
        m = self.counts / denom
        x = self.x
        return float(torch.sum(x * torch.log(m + LOG_EPS)
                               + (1.0 - x) * torch.log(1.0 - m + LOG_EPS))
                     ) / batch


def conditional_marginal_log_likelihood(params, codebook,
                                        cfg: vqvae.VqVaeConfig, dist, x,
                                        p1: int, num_smp: int, burn_in: int,
                                        generator: Optional[
                                            torch.Generator] = None,
                                        verbose: bool = False,
                                        parents=None) -> float:
    """CMLL of a test batch x [B, n_var] (numpy or a tensor); `dist` is the
    train-split CPT ([n, K], or [n, K, 2^m] with `parents` [n, m]). The
    chain runs on the params' device (on CUDA as a replayed graph) and
    draws its uniforms from `generator`, which must live there (None: one
    seeded 0): one draw of [G, blocks, B] a sub-segment of G steps (the
    chain's `sub_steps`), not one a step."""
    chain = GibbsChain(params, codebook, cfg, dist, x, p1, burn_in,
                       parents=parents)
    if generator is None:
        generator = torch.Generator(device=chain.device).manual_seed(0)
    try:
        return chain.sample_from(num_smp, generator, verbose)
    finally:
        chain.release()
