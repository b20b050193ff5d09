"""Seconds the program spent in stage 2's CPT (`Stage2.cpt`) in the run,
set-up included, counted on the host from the call to the table on the
host. The program's process counter `stage2.cpt_s`
(`pgmvae_tpu_torch.trace.counters()`); 0.0 where no CPT was made, None
where the program keeps no such counters."""

COUNTER = 'stage2.cpt_s'


def read(r):
    try:
        from pgmvae_tpu_torch import trace
    except ImportError:
        return None
    return float(trace.counters().get(COUNTER, 0.0))
