"""Model FLOP utilisation of the Gibbs chain: the analytic FLOPs of a step
(the selected networks' encoders and distance contraction over every chain
row, `work.cmll_flops_per_step`) times the measured window's steps/s, over
the card's float32 peak."""

from benchmark import work


def read(r):
    rate = r.e2e.get(r.metric['moves'])
    calls = r.work.get('vq_calls')
    if not rate or not calls:
        return None
    blocks, rows = calls[0][0], calls[0][1]
    per = work.cmll_flops_per_step(r.cfg, blocks, rows)
    return 100.0 * per * rate / work.FP32_PEAK_FLOPS
