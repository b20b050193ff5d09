"""Host data fed to the device in pieces through two pinned buffers.

A streamed epoch's chunks of batches (`train.Trainer._host_chunks`) and a
stage-2 split (`stage2.Stage2.counts`) are written on the host, one piece
at a time, into one of two pinned host buffers, and copied on a side
stream into one of two device buffers. The next piece's host work and copy
go ahead of this piece's consumer; the consumer's stream waits for its
piece's copy by an event; a host buffer is refilled only once its last copy
is done, and a device buffer only once the consumer's work on its last
piece is done (an event its stream records when the consumer takes the
next piece). So the device holds at most two pieces, whatever the data's
size; a single piece allocates one buffer of each. On the CPU the pieces
are the host buffers themselves.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import torch


def upload(host: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """One host-to-device transfer: `host` copied, without blocking, into
    the front of the device buffer `out` on the current stream; `host`
    itself when there is no device buffer (the CPU)."""
    if out is None:
        return host
    view = out[:host.shape[0]]
    view.copy_(host, non_blocking=True)
    return view


def pinned_pieces(count: int, shape: tuple, dtype: torch.dtype,
                  device: torch.device,
                  fill: Callable[[int, torch.Tensor], torch.Tensor]
                  ) -> Iterator[torch.Tensor]:
    """Yield `count` pieces on `device`. `fill(c, buf)` writes piece c into
    the host buffer `buf` of `shape` and returns the leading rows of it to
    send; the buffers start zeroed (rows or columns `fill` never writes
    stay zero). See the module doc for the order of work."""
    cuda = device.type == 'cuda'
    host, dev = [None, None], [None, None]     # allocated at first use
    copied = [None, None]            # the event of each buffer's copy
    consumed = [None, None]          # the consumer's work on each buffer
    stream = torch.cuda.Stream(device) if cuda else None

    def stage(c):
        slot = c % 2
        if host[slot] is None:
            host[slot] = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        if copied[slot] is not None:
            copied[slot].synchronize()
        view = fill(c, host[slot])
        if not cuda:
            return upload(view, None), None
        if dev[slot] is None:
            dev[slot] = torch.empty(shape, dtype=dtype, device=device)
        with torch.cuda.stream(stream):
            if consumed[slot] is not None:
                stream.wait_event(consumed[slot])
            out = upload(view, dev[slot])
            copied[slot] = torch.cuda.Event()
            copied[slot].record(stream)
        return out, copied[slot]

    try:
        ahead = stage(0) if count > 0 else None
        for c in range(count):
            piece, event = ahead
            if c + 1 < count:
                ahead = stage(c + 1)
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
            yield piece
            if cuda:
                consumed[c % 2] = torch.cuda.Event()
                consumed[c % 2].record(torch.cuda.current_stream(device))
    finally:
        if cuda:    # a copy left in flight by an early exit ends first
            torch.cuda.current_stream(device).wait_stream(stream)
