"""The Adam kernel's share of its roofline in training: 28 bytes a float32
parameter at HBM bandwidth (`work.adam_bound_s`), for every update of the
traced epoch, over the device time of the kernels named in KERNELS."""

from benchmark import work

KERNELS = ('adam_table_kernel',)


def read(r):
    if r.trace is None or not r.work.get('adam_updates'):
        return None
    seconds, count = r.trace.kernel_s(KERNELS)
    if count == 0:
        return None
    params = work.n_params(r.cfg) * r.mix['pack_seeds']
    return 100.0 * work.adam_bound_s(params) * r.work['adam_updates'] / (
        seconds)
