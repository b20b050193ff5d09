"""The device's idle share of the traced window: 100 minus the union of
the device's busy intervals (kernels, copies, sets) over the window's
length, from one profiler window. One reader for every cell:
`device.idle_pct.<kind>` names it by the end-to-end metric it moves."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
