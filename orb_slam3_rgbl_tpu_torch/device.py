"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` → ``cuda``. Raises when CUDA is asked for but absent: the
    port never falls back to the CPU on its own; the CPU is used only when
    the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StreamOrder:
    """Ordering for device tensors that several CUDA streams write and read
    (the tracking thread's stream and the mapping, loop and GBA workers').

    A writer calls ``wrote(tensors)`` after enqueueing its writes: the event
    of its stream moves to that point. A reader calls ``before_read(tensors)``
    before enqueueing its reads: its stream waits for every other stream's
    last write, on the device, without blocking the host. Both tell the
    caching allocator that their stream uses ``tensors``, so a tensor freed
    (or replaced by a larger one) on one stream is not handed out again while
    another stream's work on it is queued. On the CPU both do nothing.
    Callers serialize the two with their own lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self._events: dict = {}   # stream → event at its last write

    def _stream(self, tensors):
        s = torch.cuda.current_stream(self.device)
        for t in tensors:
            t.record_stream(s)
        return s

    def wrote(self, tensors):
        if self.device.type != "cuda":
            return
        s = self._stream(tensors)
        ev = self._events.get(s)
        if ev is None:
            ev = self._events[s] = torch.cuda.Event()
        ev.record(s)

    def before_read(self, tensors):
        if self.device.type != "cuda":
            return
        s = self._stream(tensors)
        for other, ev in self._events.items():
            if other != s:
                s.wait_event(ev)
