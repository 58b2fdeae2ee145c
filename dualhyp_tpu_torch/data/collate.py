"""Bucketed batching.

A copy of `dualhyp_tpu/data/collate.py`: batches pad to bucket boundaries,
so a handful of shapes cover the whole dataset (a decode batch pads its
prompts the same way). Pad values follow the reference (ids -> 0, labels ->
-1). `prefetch_epoch_batches` builds the batches in a producer thread.
"""

from __future__ import annotations

import random
from typing import Iterable, List, Sequence

import numpy as np

IGNORE_INDEX = -1

DEFAULT_BUCKETS = (64, 128, 192, 256, 384, 512, 640, 768, 896, 1024)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_batch(examples, buckets: Sequence[int] = DEFAULT_BUCKETS,
              max_len: int | None = None) -> dict:
    """Pack PackedExamples into fixed-shape numpy arrays.

    Sequences longer than the top bucket (or `max_len`) are truncated, like
    the reference's max_input_length clamp (ref: av_dataset.py:138-140).
    """
    longest = max(len(e.input_ids) for e in examples)
    target = bucket_length(longest, buckets)
    if max_len is not None:
        target = min(target, max_len)
    b = len(examples)
    input_ids = np.zeros((b, target), np.int32)
    labels = np.full((b, target), IGNORE_INDEX, np.int32)
    lengths = np.zeros((b,), np.int32)
    prompt_lengths = np.zeros((b,), np.int32)
    for i, ex in enumerate(examples):
        ids = ex.input_ids[:target]
        lab = ex.labels[:target]
        input_ids[i, : len(ids)] = ids
        labels[i, : len(lab)] = lab
        lengths[i] = len(ids)
        prompt_lengths[i] = min(len(ex.input_ids_no_response), target)
    return {
        "input_ids": input_ids,
        "labels": labels,
        "lengths": lengths,
        "prompt_lengths": prompt_lengths,
        "uids": [e.uid for e in examples],
        "ground_truths": [e.ground_truth for e in examples],
        "examples": examples,
    }


def epoch_batches(dataset, batch_size: int, *, shuffle: bool, seed: int,
                  epoch: int, buckets: Sequence[int] = DEFAULT_BUCKETS,
                  drop_last: bool = False,
                  length_sorted: bool = False,
                  process_index: int = 0,
                  process_count: int = 1) -> Iterable[dict]:
    """Yield padded batches for one epoch.

    `length_sorted=True` groups similarly-sized examples (after a seeded
    shuffle of group order) to minimise padding waste.

    Multi-host: every process shuffles with the SAME seed (deterministic),
    then takes its `process_index::process_count` slice (reference seeds
    1337+rank per process, ref: finetune/ger.py:135).
    """
    order = list(range(len(dataset)))
    rng = random.Random(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    if process_count > 1:
        order = order[process_index::process_count]
    examples = [dataset[i] for i in order]
    if length_sorted:
        examples.sort(key=lambda e: len(e.input_ids))
        chunks = [
            examples[i : i + batch_size] for i in range(0, len(examples), batch_size)
        ]
        rng.shuffle(chunks)
        flat: List = [e for chunk in chunks for e in chunk]
        examples = flat
    for i in range(0, len(examples), batch_size):
        chunk = examples[i : i + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        yield assemble_batch(chunk, batch_size, buckets)


def assemble_batch(chunk, batch_size: int, buckets: Sequence[int]) -> dict:
    """Pad one chunk of examples to a static batch; a short final chunk
    repeat-pads with zero-loss rows (labels -> IGNORE_INDEX, valid=0)."""
    if len(chunk) < batch_size:
        pad = [chunk[-1]] * (batch_size - len(chunk))
        batch = pad_batch(chunk + pad, buckets)
        batch["labels"][len(chunk):] = IGNORE_INDEX  # no loss on repeats
        batch["valid"] = np.asarray(
            [1] * len(chunk) + [0] * (batch_size - len(chunk)), np.int32
        )
        return batch
    batch = pad_batch(chunk, buckets)
    batch["valid"] = np.ones((batch_size,), np.int32)
    return batch


def prefetch_epoch_batches(dataset, batch_size: int, *, shuffle: bool,
                           seed: int, epoch: int,
                           buckets: Sequence[int] = DEFAULT_BUCKETS,
                           drop_last: bool = False,
                           process_index: int = 0,
                           process_count: int = 1,
                           prefetch: int = 2) -> Iterable[dict]:
    """`epoch_batches` with lazy, pipelined example fetching.

    `epoch_batches` materialises the WHOLE epoch before the first batch —
    fine for the text-only GER path (tokenise once), but a long stall when
    corruption is enabled and __getitem__ loads waveforms/mouth-ROI HDF5
    (the RelPrompt training path; the reference leans on torch DataLoader
    workers, ref: finetune/ger.py:173-174). A producer thread builds
    padded batches into a bounded queue, overlapping host-side IO/packing
    with device compute (the train step runs asynchronously on the card, so
    the queue fills while it works). The producer fetches examples
    SEQUENTIALLY: the datasets consume a shared seeded RNG per
    __getitem__, so parallel fetching would race it and change the draw
    sequence. Batch order/content identical to `epoch_batches` without
    `length_sorted` (tested)."""
    import queue
    import threading

    order = list(range(len(dataset)))
    rng = random.Random(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    if process_count > 1:
        order = order[process_index::process_count]

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    _END = object()
    stop = threading.Event()  # set when the consumer abandons the generator

    def _put(item) -> bool:
        """put() that gives up once the consumer is gone, so an abandoned
        generator (e.g. the NaN SystemExit in finetune_ger) does not leak
        a thread blocked forever on a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for i in range(0, len(order), batch_size):
                idxs = order[i : i + batch_size]
                if drop_last and len(idxs) < batch_size:
                    break
                chunk = [dataset[j] for j in idxs]
                if not _put(assemble_batch(chunk, batch_size, buckets)):
                    return
            _put(_END)
        except BaseException as exc:  # surface in the consumer
            _put(exc)

    worker = threading.Thread(target=produce, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join(timeout=5.0)
