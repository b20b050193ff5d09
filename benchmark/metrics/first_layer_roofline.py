"""The masked first layer's kernel share of its roofline: for each call of
the traced window, the larger of 2 S B n n o operations at the float32
peak and 4 (S n n o + S B n + S n B o) bytes at HBM bandwidth (the layer's
full n x n x o weights of S packed seeds read once, the rows read and the
output written once; n = n_var, o = the first hidden width), summed, over
the device time of the kernels named in KERNELS. A training step makes one
call of its batch's rows, a scoring request one of its rows: the calls are
the traced window's nearest-code searches (`vq_calls`: S n networks, B
rows each), one a forward pass. One reader for every cell:
`first_layer_roofline.<kind>` names it by the end-to-end metric it moves.
Where no kernel of that name ran (a program that builds the [n, B, n]
masked input), it reads nothing."""

from benchmark import work

KERNELS = ('first_layer_kernel',)


def bound_s(s: int, b: int, n: int, o: int) -> float:
    """Least time of one masked first layer over s seeds of b rows."""
    flops = 2.0 * s * b * n * n * o
    nbytes = 4.0 * (s * n * n * o + s * b * n + s * n * b * o)
    return max(flops / work.FP32_PEAK_FLOPS, nbytes / work.HBM_BYTES_PER_S)


def read(r):
    if r.trace is None or not r.work.get('vq_calls'):
        return None
    seconds, count = r.trace.kernel_s(KERNELS)
    if count == 0:
        return None
    n, o = r.cfg['n_var'], r.cfg['units'][0]
    bound = sum(bound_s(nets // n, b, n, o)
                for nets, b, _, _ in r.work['vq_calls'])
    return 100.0 * bound / seconds
