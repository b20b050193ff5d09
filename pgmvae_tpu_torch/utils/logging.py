"""Run identifiers, epoch metrics and the `result.txt` line (the port's own
copy of `pgmvae_tpu/utils/logging.py`, which it never imports).

- `run_identifier` / `parse_identifier`: the hyperparameter-encoding run id,
  byte-equal to the JAX package's for the same settings, and its lossless
  inverse (rebuilt through the port's `driver.ExperimentConfig`);
- `MetricLogger`: per-epoch metrics as JSONL under
  `logs/tuning/<identifier>/`, with TensorBoard event files beside them
  when a writer is importable;
- `append_result`: the one-line-per-run `result.txt` append.
"""

from __future__ import annotations

import json
import os
import re
import time

# A note whose tail LOOKS like an identifier extension field (e.g. note
# 'x_pk-3' or 'foo_nzd') would be peeled into the wrong config field by
# parse_identifier, yet rebuild byte-identically — a silently lossy parse,
# exactly the failure the round-trip check exists to prevent (round-4
# advisor finding). Such notes are rejected at identifier-build time.
_AMBIGUOUS_NOTE = re.compile(
    r'_(?:qz|un|fm|dcr|prc|act|l2|sov|cptp|fl|pk|ad|cd|cpe)-|_(?:nzd|cpm)$')


def run_identifier(name, k, d, bs, epochs, lr, beta, ema, gamma, seed,
                   note='', *, quantizer=None, units=None,
                   fan_mode='tf_stacked', dead_code_threshold=0.0,
                   zero_debias=True, precision='default',
                   activation='selu', l2_reg=0.0,
                   select_on_valid=0, cpt_parents=0,
                   first_layer='masked', packed_seeds=1,
                   adam_impl='optax', compute_dtype='f32',
                   cpt_parents_eval=(), cpt_parents_mix=False) -> str:
    """Hyperparameter-encoding run id, field-for-field the reference's
    format (reference run.py:38).

    Extension hyperparameters beyond the reference's surface are appended
    as extra `_key-value` fields ONLY when they differ from their defaults,
    so (a) reference-compatible runs keep the exact reference identifier and
    (b) two sweep cells that differ in any semantic knob can never collide
    in a joblog or result file."""
    if note and _AMBIGUOUS_NOTE.search(note):
        raise ValueError(
            f'note {note!r} is separator-ambiguous: it contains an '
            f'identifier-extension pattern (_<ext>-... or _nzd tail) that '
            f'parse_identifier would peel into the wrong field')
    base = (f"{name}_K-{k}_D-{d}_bs-{bs}_epk-{epochs}_lr-{lr}_bta-{beta}"
            f"_ema-{ema}_gma-{gamma}_sd-{seed}-{note}")
    ext = []
    if quantizer and quantizer != ('ema' if ema else 'vq'):
        ext.append(f'qz-{quantizer}')
    if units:
        ext.append('un-' + 'x'.join(str(u) for u in units))
    if fan_mode != 'tf_stacked':
        ext.append(f'fm-{fan_mode}')
    if dead_code_threshold:
        ext.append(f'dcr-{dead_code_threshold}')
    if not zero_debias:
        ext.append('nzd')
    if precision != 'default':
        ext.append(f'prc-{precision}')
    if activation != 'selu':
        ext.append(f'act-{activation}')
    if l2_reg:
        ext.append(f'l2-{l2_reg}')
    if select_on_valid:
        ext.append(f'sov-{select_on_valid}')
    if cpt_parents:
        ext.append(f'cptp-{cpt_parents}')
    if first_layer != 'masked':
        ext.append(f'fl-{first_layer}')
    if packed_seeds and packed_seeds > 1:
        # the cell ran as one lane of an S-seed vmapped program — a
        # numerically distinct trajectory (ExperimentConfig.packed_seeds)
        ext.append(f'pk-{packed_seeds}')
    if adam_impl != 'optax':
        # recorded as the JAX package records it (there fused/pallas Adam
        # drift ~1 ULP a step from optax); the port runs one kernel for
        # all three
        ext.append(f'ad-{adam_impl}')
    if compute_dtype != 'f32':
        # bf16 forward/backward (VqVaeConfig.compute_dtype): a genuinely
        # different training trajectory, not a fusion ULP
        ext.append(f'cd-{compute_dtype}')
    if cpt_parents_eval:
        # post-hoc joint-CPT evaluation list (ExperimentConfig
        # .cpt_parents_eval): stage-2-only — training is unchanged, each
        # listed M yields its own cpe-M record from the same trained state
        ext.append('cpe-' + '.'.join(str(m) for m in cpt_parents_eval))
    if cpt_parents_mix:
        # mixed parent-count record: each variable's M chosen on its valid
        # PLL contribution from the candidate set {cptp-M} + the cpe list
        # (driver._posthoc_cpt_records) — fully determined by those fields,
        # so cpm is a bare flag
        ext.append('cpm')
    return base + ('_' + '_'.join(ext) if ext else '')


def parse_identifier(identifier: str):
    """Invert `run_identifier` into `ExperimentConfig` kwargs — losslessly.

    Campaign scripts (CMLL reruns, joint-CPT sweeps) re-run recipes recovered
    from winner identifiers; a lossy parse silently re-measures a *different*
    recipe (round-3 advisor finding). This parser peels the fixed-order
    extension fields from the right, then verifies the round trip: the
    reconstructed config's `.identifier` must be byte-identical to the input,
    else ValueError. Returns a dict of ExperimentConfig kwargs (incl. name).
    """
    import re

    m = re.match(
        r'^(?P<name>.+?)_K-(?P<k>\d+)_D-(?P<d>\d+)_bs-(?P<bs>\d+)'
        r'_epk-(?P<epk>\d+)_lr-(?P<lr>[0-9.e+-]+)_bta-(?P<bta>[0-9.e+-]+)'
        r'_ema-(?P<ema>True|False)_gma-(?P<gma>[0-9.e+-]+)'
        r'_sd-(?P<sd>-?\d+)-(?P<rest>.*)$', identifier)
    if not m:
        raise ValueError(f'unparseable identifier: {identifier!r}')
    g = m.groupdict()
    kw = dict(name=g['name'], embedding=int(g['k']), dim=int(g['d']),
              batch=int(g['bs']), epoch=int(g['epk']), rate=float(g['lr']),
              cost=float(g['bta']), ema=g['ema'] == 'True',
              decay=float(g['gma']), seed=int(g['sd']))

    # peel extensions right-to-left in reverse append order (run_identifier)
    rest = g['rest']
    peels = [
        ('cpt_parents_mix', r'_(cpm)$', lambda _: True),
        ('cpt_parents_eval', r'_cpe-([0-9.]+)$',
         lambda v: tuple(int(x) for x in v.split('.'))),
        ('compute_dtype', r'_cd-(bf16)$', str),
        ('adam_impl', r'_ad-(fused|pallas|fused_bf16)$', str),
        ('packed_seeds', r'_pk-(\d+)$', int),
        ('first_layer', r'_fl-(rank1|auto)$', str),
        ('cpt_parents', r'_cptp-(\d+)$', int),
        ('select_on_valid', r'_sov-(\d+)$', int),
        ('l2_reg', r'_l2-([0-9.e+-]+)$', float),
        ('activation', r'_act-([a-z0-9_]+)$', str),
        ('precision', r'_prc-([a-z0-9_]+)$', str),
        ('zero_debias', r'_(nzd)$', lambda _: False),
        ('dead_code_threshold', r'_dcr-([0-9.e+-]+)$', float),
        ('fan_mode', r'_fm-(per_network)$', str),
        ('units', r'_un-([0-9x]+)$',
         lambda v: tuple(int(u) for u in v.split('x'))),
        ('quantizer', r'_qz-([a-z0-9_]+)$', str),
    ]
    for field, pat, conv in peels:
        pm = re.search(pat, rest)
        if pm:
            kw[field] = conv(pm.group(1))
            rest = rest[:pm.start()]
    kw['note'] = rest

    from pgmvae_tpu_torch.driver import ExperimentConfig
    rebuilt = ExperimentConfig(**kw).identifier
    if rebuilt != identifier:
        raise ValueError(
            f'identifier round-trip failed (lossy parse):\n'
            f'  input:   {identifier!r}\n  rebuilt: {rebuilt!r}')
    return kw


class MetricLogger:
    """Per-run observability: append-only JSONL epoch metrics under
    logs/tuning/<identifier>/, plus TensorBoard event files in the same
    directory when a writer is importable (torch's, here) — preserving the
    reference's TensorBoard contract (reference run.py:39-40) without a TF
    dependency. TensorBoard is best-effort; JSONL is the source of truth."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, 'metrics.jsonl')
        self._f = open(self._path, 'a', buffering=1)
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception as e:  # noqa: BLE001 — TB is optional
                # the reference's TensorBoard contract (ref run.py:39-40)
                # degrades to JSONL-only; say so instead of silently
                import warnings
                warnings.warn(
                    f'TensorBoard event writing unavailable '
                    f'({type(e).__name__}: {e}); epoch metrics go to '
                    f'{self._path} only', stacklevel=2)
                self._tb = None

    def log_epoch(self, epoch: int, metrics) -> None:
        rec = {'epoch': epoch, 'wall': round(time.time() - self._t0, 3)}
        if hasattr(metrics, '_asdict'):
            metrics = metrics._asdict()
        rec.update({k: float(v) for k, v in dict(metrics).items()})
        self._f.write(json.dumps(rec) + '\n')
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ('epoch',):
                    self._tb.add_scalar(f'epoch/{k}', v, epoch)

    def log_final(self, **kv) -> None:
        rec = {'final': True, 'wall': round(time.time() - self._t0, 3)}
        rec.update(kv)
        self._f.write(json.dumps(rec) + '\n')
        if self._tb is not None:
            for k, v in rec.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._tb.add_scalar(f'final/{k}', v, 0)
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def append_result(identifier: str, pll_train, pll_valid, pll_test,
                  cmll_test=1, path: str = 'result.txt') -> str:
    """Append the canonical one-line result (reference run.py:77-80).
    `cmll_test` defaults to the literal 1 the reference hardcodes when the
    Gibbs evaluation is disabled (reference run.py:77)."""
    out = (f' pll-train:{pll_train} pll-valid:{pll_valid}'
           f' pll-test:{pll_test} cmll-test:{cmll_test}')
    line = identifier + out
    with open(path, 'a') as f:
        f.write(line + '\n')
    return line
