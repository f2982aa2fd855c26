"""One driver per kind of traffic, found by the ``driver`` key of a traffic file.

A driver's ``Run(config, traffic, seed, device, tracing, fault=None)`` sets
up in its constructor (``phases`` holds the seconds of each step of it),
then offers ``window(seconds)``, ``traced()``, ``free()`` and ``check()``."""

import time


class Phases(dict):
    """Seconds by phase of a set-up, each taken since the previous one."""

    def __init__(self) -> None:
        super().__init__()
        self._last = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self._last
        self._last = now
