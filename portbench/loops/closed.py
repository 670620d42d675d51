"""One client in a closed loop: the next call as soon as the last returns,
until ``seconds`` have passed.  Each call is timed on the host clock from
its start to a synchronize after it."""

from __future__ import annotations

import time


def run(entry, seconds: float, gen, sync, keep) -> dict:
    """Drive ``entry`` for ``seconds``; ``keep(problems, out)`` stores each
    call's answers.  Returns the window's ``window_s`` and ``call_s``."""
    call_s = []
    t0 = time.perf_counter()
    while True:
        problems, args = entry.feed(gen)
        sync()
        t1 = time.perf_counter()
        out = entry.solve(args)
        sync()
        t2 = time.perf_counter()
        call_s.append(t2 - t1)
        keep(problems, out)
        if t2 - t0 >= seconds:
            return {"window_s": t2 - t0, "call_s": call_s}
