"""Shared plumbing for the multi-stream device serving entry points.

ThreadedDrainer: downloads (the np.asarray of each group's device
result) ride a background thread so they overlap the host parse of
later groups — device-to-host copies release the GIL, so the host keeps
parsing while PCM streams back, and the wall tends toward
max(host_parse, downloads) + tails instead of their sum.

Order is preserved per stream: one FIFO queue, one consumer thread —
groups append to outs[] in dispatch order.
"""
from __future__ import annotations

import queue
import threading


class ThreadedDrainer:
    """Consume (resolve, meta) pairs in order on a worker thread.

    ``sink(result, meta)`` runs on the worker for each pair; call
    ``put`` after each dispatch and ``close`` (which joins and
    re-raises any worker error) when all groups are in.  ``maxsize``
    bounds in-flight device results (backpressure against unbounded
    device-buffer growth, same role as the old ``len(pending) >= 4``).
    """

    def __init__(self, sink, maxsize: int = 4):
        self._sink = sink
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: list = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            resolve, meta = item
            try:
                self._sink(resolve(), meta)
            except Exception as e:                       # noqa: BLE001
                self._err.append(e)
                return

    def put(self, resolve, meta):
        if self._err:
            raise self._err[0]
        self._q.put((resolve, meta))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]
