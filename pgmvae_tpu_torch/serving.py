"""Serving / inference on a trained parameter-tying model (the port of
`pgmvae_tpu/serving.py`).

The deployable artifact is encoder weights + per-variable codebooks + the
stage-2 CPT (`dist`):

- `conditional_probability(y, fts)`: p(y_v=1 | rest) for selected variables;
- `score(y)`: per-sample pseudo-log-likelihood; its mean over a split equals
  the stage-2 PLL;
- `codes(y)`: each sample's discrete code per variable.

Every call encodes through the nearest-code kernel on the model's device.
`PgmModel.from_checkpoint` serves a checkpoint file of either package,
a `<checkpoint>.mix` mixture included.
"""

from __future__ import annotations

import numpy as np
import torch

from pgmvae_tpu_torch import checkpoint as ckpt
from pgmvae_tpu_torch import resolve_device
from pgmvae_tpu_torch.gibbs import get_probability
from pgmvae_tpu_torch.models import vqvae
from pgmvae_tpu_torch.stage2 import LOG_EPS, joint_cells
from pgmvae_tpu_torch.trace import span


class PgmModel:
    """Inference wrapper over (config, params, codebook, dist) on `device`;
    params and codebook are moved there."""

    def __init__(self, cfg: vqvae.VqVaeConfig, params, codebook,
                 dist: np.ndarray, parents: np.ndarray = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = vqvae.map_params(lambda p: p.to(self.device), params)
        self.codebook = None if codebook is None else codebook.to(self.device)
        self.dist = np.asarray(dist, np.float64)
        # joint-code CPTs: dist is [n, K, 2^m] and every lookup also keys on
        # the sample's values at v's parents
        self.parents = (None if parents is None else torch.as_tensor(
            np.asarray(parents, np.int32), dtype=torch.long,
            device=self.device))
        self._dist32 = torch.as_tensor(self.dist.astype(np.float32),
                                       device=self.device)

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> 'PgmModel':
        """Serve a checkpoint written with a CPT (`dist`), on `device`
        (None means CUDA). Joint-code tables take their parents from the
        file's `extra['cpt_parents']`."""
        cfg, state, dist, extra = ckpt.load(path)
        if dist is None:
            raise ValueError(f'{path} has no CPT (dist); run stage 2 and '
                             f'save with dist= before serving')
        params = ckpt.params_from_state(state['params'])
        if cfg.quantizer == 'ema':
            codebook = torch.from_numpy(np.array(state['ema']['codebook']))
        else:                        # 'vq' trains it; 'naive' has none
            codebook = params.get('codebook')
        return cls(cfg, params, codebook, dist,
                   parents=extra.get('cpt_parents'), device=device)

    def _tensor(self, y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(y, np.float32), device=self.device)

    def _codes(self, y: torch.Tensor) -> torch.Tensor:
        return vqvae.encode_codes(self.params, self.codebook, y, self.cfg)

    def codes(self, y) -> np.ndarray:
        """[B, n_var] int32: the tied-parameter code of each (sample,
        variable), computed from the sample WITHOUT variable v."""
        return self._codes(self._tensor(y)).T.cpu().numpy()

    def score(self, y) -> np.ndarray:
        """Per-sample PLL [B] float32 (sum over variables of
        log p(y_v | code)). The mean over a split equals
        stage2.pseudo_log_likelihood to float tolerance. Host spans: the
        request `serve.score`, and in it `serve.to_device` (the rows'
        copy), `serve.encode` (the code search), `serve.lookup` (the CPT
        gather and log-likelihood) and `serve.to_host`."""
        with span('serve.score'), torch.no_grad():
            with span('serve.to_device'):
                y = self._tensor(y)
            with span('serve.encode'):
                codes = self._codes(y).long()                 # [n, B]
            with span('serve.lookup'):
                dist = self._dist32
                if self.parents is not None:
                    codes = joint_cells(
                        codes, y[:, self.parents].transpose(0, 1))
                    dist = dist.reshape(dist.shape[0], -1)
                p1 = torch.gather(dist, 1, codes)             # [n, B]
                yt = y.T
                ll = (yt * torch.log(p1 + LOG_EPS)
                      + (1.0 - yt) * torch.log(1.0 - p1 + LOG_EPS)).sum(0)
            with span('serve.to_host'):
                return ll.cpu().numpy()                       # [B]

    def conditional_probability(self, y, fts) -> np.ndarray:
        """p(y_v=1 | y_{-v}) for variables `fts` [F], given full-width
        samples y — [B, n_var] shared, or [F, B, n_var] one state per
        selection — as [F, B] float32."""
        fts = torch.as_tensor(np.asarray(fts, np.int64), device=self.device)
        with torch.no_grad():
            prb = get_probability(self.params, self.codebook, self.cfg,
                                  self._dist32, self._tensor(y), fts,
                                  parents=self.parents)
        return prb.cpu().numpy()
