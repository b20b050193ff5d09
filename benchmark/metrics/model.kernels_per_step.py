"""Device kernels a training step: the kernel launches of the traced epoch
(device events that are not copies or sets) over its steps. An exact
count: fusing kernels moves it."""


def read(r):
    if r.trace is None or not r.work.get('steps'):
        return None
    n = r.trace.n_kernels()
    return n / r.work['steps'] if n else None
