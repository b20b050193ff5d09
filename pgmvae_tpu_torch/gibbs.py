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

Each step takes its uniforms [blocks, B] as an argument: the public
function draws them from a `torch.Generator` on the chain's device, and a
test can feed the JAX package's `uniform(fold_in(key, i), (blocks, B))`
through the same chain. The chain runs eagerly, one step after another,
with the counts on the device until the end: no step reads the device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from pgmvae_tpu_torch.models import vqvae

LOG_EPS = 1e-5          # reference core/model.py:148
SEGMENT_STEPS = 8192    # steps between progress lines (the JAX package's
#                         segment: one device execution there)


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
    m = parents.shape[1]
    n_states = 1 << m
    par = parents.long().index_select(0, fts)                     # [n_sel,m]
    if y.dim() == 2:
        vals = y[:, par].permute(1, 0, 2)                         # [n_sel,B,m]
    else:
        vals = torch.gather(y, 2, par[:, None, :].expand(-1, y.shape[1], -1))
    pw = 1 << torch.arange(m, device=y.device)
    j = (vals.long() * pw).sum(-1)                                # [n_sel,B]
    prb = dist.reshape(dist.shape[0], -1).index_select(0, fts)    # [n_sel,K*2^m]
    return torch.gather(prb, 1, codes * n_states + j)


class GibbsChain:
    """The blockwise chain over a test batch x [B, n] on the params'
    device: `state` [blocks, B, n_var] and `counts` [B, n], both float32,
    updated in place by `step`."""

    def __init__(self, params, codebook, cfg: vqvae.VqVaeConfig, dist, x,
                 p1: int, burn_in: int, parents=None):
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

    def step(self, i: int, u: torch.Tensor) -> None:
        """Gibbs step i with uniforms u [blocks, B]: block b resamples
        variable marker_b + i mod vol_b; steps past burn_in*p1 count."""
        y = self.marker + torch.remainder(i, self.vol)       # [blocks]
        prb = get_probability(self.params, self.codebook, self.cfg,
                              self.dist, self.state, y, parents=self.parents)
        gibbs = (u < prb).to(self.state.dtype)               # [blocks, B]
        self.state.scatter_(
            2, y.view(-1, 1, 1).expand(-1, self.state.shape[1], 1),
            gibbs[:, :, None])
        if i > self.burn_in * self.p1:       # strict >, ref core/model.py:139
            self.counts.index_add_(1, y, gibbs.T)

    def run(self, start: int, steps: int,
            uniform: Callable[[int], torch.Tensor]) -> None:
        """Steps start .. start+steps-1, step i with uniforms `uniform(i)`."""
        with torch.no_grad():
            for i in range(start, start + steps):
                self.step(i, uniform(i))

    def sample(self, num_smp: int, uniform: Callable[[int], torch.Tensor],
               verbose: bool = False) -> float:
        """Run the whole chain (num_smp * p1 steps from step 0) and return
        its CMLL. `verbose` prints progress every SEGMENT_STEPS steps."""
        total, done = int(num_smp) * self.p1, 0
        while done < total:
            seg = min(SEGMENT_STEPS, total - done)
            self.run(done, seg, uniform)
            done += seg
            if verbose:
                # sampling progress, as the reference prints it under
                # `verbose` (reference core/model.py:141-142)
                print(f'cmll sampling step {done}/{total}', flush=True)
        return self.cmll(num_smp)

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
    chain runs on the params' device and draws its uniforms from
    `generator`, which must live there (None: one seeded 0)."""
    chain = GibbsChain(params, codebook, cfg, dist, x, p1, burn_in,
                       parents=parents)
    if generator is None:
        generator = torch.Generator(device=chain.device).manual_seed(0)
    shape = (chain.blocks, chain.x.shape[0])

    def uniform(i: int) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=chain.device)

    return chain.sample(num_smp, uniform, verbose=verbose)
