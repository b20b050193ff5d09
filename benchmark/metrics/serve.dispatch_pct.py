"""The share of a scoring request's service in which the card waits on the
host: over the traced window's `serve.score` host spans (the program's span
of one request, `PgmModel.score`), each span's length less the union of the
device's busy intervals inside it, summed, over the spans' summed length.
None without such spans or without device events (the CPU, or a program
that has no such span)."""

import bisect

SPAN = 'serve.score'


def busy_intervals(kernels) -> list:
    """The union of device events sorted by start, as disjoint [start, end]
    pairs in order."""
    out = []
    for e in kernels:
        if out and e.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e.end)
        else:
            out.append([e.start, e.end])
    return out


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    spans = [h for h in r.trace.host
             if h.name == SPAN and h.start >= lo and h.end <= hi]
    total = sum(h.end - h.start for h in spans)
    if total <= 0:
        return None
    busy = busy_intervals(r.trace.kernels)
    starts = [b[0] for b in busy]
    covered = 0
    for h in spans:
        i = max(bisect.bisect_right(starts, h.start) - 1, 0)
        while i < len(busy) and busy[i][0] < h.end:
            covered += max(0, min(busy[i][1], h.end)
                           - max(busy[i][0], h.start))
            i += 1
    return 100.0 * (total - covered) / total
