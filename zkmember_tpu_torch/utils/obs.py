"""Phase timers (counterpart of the ``Profiler`` of zkmember_tpu.utils.obs).

One ``PhaseClock`` serves setup and both provers: each ``mark(name)`` adds
the host seconds since the previous mark to ``times[name]``.  The card is
synchronized at every mark, so each phase holds its own device work; with
``times=None`` (what a caller gets unless it asks for phase times) a mark
is a no-op and adds no synchronization.
"""

from __future__ import annotations

import time

import torch


class PhaseClock:
    def __init__(self, times: dict | None, device=None):
        self.times = times
        self.device = torch.device(device) if device is not None else None
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.times is None:
            return
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        self.t = now
