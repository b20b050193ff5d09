"""Seconds the program spent capturing its step graphs in the run, set-up
included: for each capture its warm-up step and the record (which begins
with the device synchronisation of `torch.cuda.graph`). The program's
process counter
`graph.capture_s` (`pgmvae_tpu_torch.trace.counters()`); 0.0 where nothing
was captured (the CPU), None where the program keeps no such counters."""

COUNTER = 'graph.capture_s'


def read(r):
    try:
        from pgmvae_tpu_torch import trace
    except ImportError:
        return None
    return float(trace.counters().get(COUNTER, 0.0))
