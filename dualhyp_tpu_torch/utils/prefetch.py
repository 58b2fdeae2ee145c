"""Background-thread prefetch for host -> device pipelines.

A copy of `dualhyp_tpu/utils/prefetch.py`. `prefetch` runs a host-side
batch generator in ONE producer thread with a bounded queue, overlapping
the preparation of batch N+1 (wav/video loading, noise mixing, STFT; numpy
releases the GIL there) with the device's work on batch N. A single
producer keeps the generator's rng draw order, so outputs stay
bit-identical to the sequential loop.
"""

from __future__ import annotations

import queue
import threading

_DONE = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(gen, depth: int = 2):
    """Yield items of `gen` in order, producing them in a background
    thread up to `depth` items ahead. Exceptions inside `gen` re-raise
    at the consumption point. Closing the returned generator early
    (break / .close()) stops the producer promptly."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def run():
        try:
            for item in gen:
                while True:
                    if stop.is_set():
                        return
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # re-raised by the consumer
            q.put(_Raised(exc))
            return
        q.put(_DONE)

    producer = threading.Thread(
        target=run, name="dualhyp-prefetch", daemon=True
    )
    producer.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, _Raised):
                raise item.exc
            yield item
        producer.join()
    finally:
        stop.set()
