"""The nearest-code kernel's share of its roofline: for each search of the
traced window, from its shape (n, B, D, K), the larger of 2nBDK operations
at the float32 peak and 4n(BD + DK + B) bytes at HBM bandwidth
(`work.vq_bound_s`), summed, over the device time of the kernels named in
KERNELS. One reader for every cell: `vq_argmin_roofline.<kind>` names it
by the end-to-end metric it moves."""

from benchmark import work

KERNELS = ('vq_argmin_kernel', 'vq_merge_kernel')


def read(r):
    if r.trace is None or not r.work.get('vq_calls'):
        return None
    seconds, count = r.trace.kernel_s(KERNELS)
    if count == 0:
        return None
    bound = sum(work.vq_bound_s(*shape) for shape in r.work['vq_calls'])
    return 100.0 * bound / seconds
