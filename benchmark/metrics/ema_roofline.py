"""The EMA codebook step's kernel share of its roofline in training: for
each update of the traced epoch, 4N(3DK + 2K) bytes at HBM bandwidth (read
dw and the counts, write dw, the codebook and the counts; N = n_var times
the packed seeds), over the device time of the kernels named in KERNELS.
The bound is this reader's own. Where no kernel of that name ran (a program
that takes the step in separate operations), it reads nothing."""

from benchmark import work

KERNELS = ('ema_update_kernel',)


def bound_s(n: int, d: int, k: int) -> float:
    """Least time of one EMA codebook step over n networks of D x K."""
    return 4.0 * n * (3 * d * k + 2 * k) / work.HBM_BYTES_PER_S


def read(r):
    if r.trace is None or not r.work.get('steps'):
        return None
    seconds, count = r.trace.kernel_s(KERNELS)
    if count == 0:
        return None
    n = r.cfg['n_var'] * r.mix['pack_seeds']
    return 100.0 * bound_s(n, r.cfg['dim'], r.cfg['num_codes']) * (
        r.work['steps']) / seconds
