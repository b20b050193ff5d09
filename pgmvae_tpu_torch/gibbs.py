"""The model conditional p(y_v = 1 | rest) that serving and Gibbs sampling
read (the port of `get_probability` in `pgmvae_tpu/gibbs.py`). The CMLL
chain itself is not ported yet."""

from __future__ import annotations

import torch

from pgmvae_tpu_torch.models import vqvae


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
