"""Model FLOP utilisation of scoring while a request is served: the
analytic FLOPs of encoding and quantizing every row of the traced window's
requests (`work.encode_flops_per_row`) over the seconds the requests took
from going out to their answers (queueing left out: the open loop fixes
the offered rate), over the card's float32 peak."""

from benchmark import work


def read(r):
    if not r.work.get('service_s'):
        return None
    flops = work.encode_flops_per_row(r.cfg) * r.work['rows']
    return 100.0 * flops / r.work['service_s'] / work.FP32_PEAK_FLOPS
