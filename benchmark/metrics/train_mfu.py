"""Model FLOP utilisation of training: the analytic model FLOPs of a
trained sample (`work.train_flops_per_sample`) times the measured window's
samples/s, over the card's float32 peak."""

from benchmark import work


def read(r):
    rate = r.e2e.get(r.metric['moves'])
    if not rate:
        return None
    per = work.train_flops_per_sample(r.cfg)
    return 100.0 * per * rate / work.FP32_PEAK_FLOPS
