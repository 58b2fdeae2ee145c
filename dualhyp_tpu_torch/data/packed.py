"""Packed binary pretraining dataset (Megatron-style chunked shards).

A copy of `dualhyp_tpu/data/packed.py` (ref: ger/packed_dataset.py:27-235):
a builder writes fixed-size token chunks to versioned binary files; an
iterator streams `block_size` windows with optional shuffling and
shard-per-worker partitioning; a weighted combiner mixes several datasets.
numpy only, memory-mapped reads; the files are the JAX package's, byte for
byte.

File format: magic | version | dtype code | chunk_size, then raw tokens.
"""

from __future__ import annotations

import random
import struct
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np

MAGIC = b"DHYPPACK"
VERSION = 1

_DTYPES = {1: np.uint16, 2: np.int32, 3: np.int64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HEADER = struct.Struct("<8sHHI")  # magic, version, dtype code, chunk_size


class PackedDatasetBuilder:
    """Accumulates token ids and writes fixed-size chunk files."""

    def __init__(self, outdir, prefix: str, chunk_size: int,
                 sep_token: int = 0, dtype=np.uint16):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.chunk_size = chunk_size
        self.sep_token = sep_token
        self.dtype = np.dtype(dtype)
        self._buffer = np.full(chunk_size, sep_token, self.dtype)
        self._idx = 0
        self._counter = 0
        self.filenames: List[str] = []

    def add_array(self, arr) -> None:
        arr = np.asarray(arr, self.dtype)
        while self._idx + len(arr) > self.chunk_size:
            part = self.chunk_size - self._idx
            self._buffer[self._idx :] = arr[:part]
            arr = arr[part:]
            self._idx = self.chunk_size
            self._write_chunk()
        self._buffer[self._idx : self._idx + len(arr)] = arr
        self._idx += len(arr)

    def _write_chunk(self) -> None:
        fname = self.outdir / f"{self.prefix}_{self._counter:010d}.bin"
        with open(fname, "wb") as fp:
            fp.write(
                _HEADER.pack(MAGIC, VERSION, _DTYPE_CODES[self.dtype],
                             self.chunk_size)
            )
            fp.write(self._buffer.tobytes())
        self.filenames.append(str(fname))
        self._counter += 1
        self._buffer[:] = self.sep_token
        self._idx = 0

    def write_reminder(self) -> None:
        if self._idx:
            self._idx = self.chunk_size
            self._write_chunk()


def _read_chunk(path):
    with open(path, "rb") as fp:
        magic, version, code, chunk_size = _HEADER.unpack(fp.read(_HEADER.size))
    assert magic == MAGIC and version == VERSION, path
    data = np.memmap(path, dtype=_DTYPES[code], mode="r",
                     offset=_HEADER.size, shape=(chunk_size,))
    return data


class PackedDataset:
    """Streams (block_size,) windows from chunk files.

    Shard-per-worker: worker w of n reads files w::n (ref:
    ger/packed_dataset.py:47-57)."""

    def __init__(self, filenames: Sequence[str], block_size: int,
                 n_blocks_per_chunk: Optional[int] = None, seed: int = 12345,
                 shuffle: bool = True, wrap: bool = False,
                 worker_index: int = 0, num_workers: int = 1):
        self.filenames = list(filenames)[worker_index::num_workers]
        self.block_size = block_size
        self.seed = seed
        self.shuffle = shuffle
        self.wrap = wrap

    def __iter__(self) -> Iterable[np.ndarray]:
        rng = random.Random(self.seed)
        files = list(self.filenames)
        while True:
            if self.shuffle:
                rng.shuffle(files)
            for fname in files:
                chunk = _read_chunk(fname)
                n_blocks = len(chunk) // self.block_size
                order = list(range(n_blocks))
                if self.shuffle:
                    rng.shuffle(order)
                for b in order:
                    yield np.asarray(
                        chunk[b * self.block_size : (b + 1) * self.block_size]
                    )
            if not self.wrap:
                return


class CombinedDataset:
    """Weighted mixture of iterables (ref: ger/packed_dataset.py:214-235)."""

    def __init__(self, datasets: Sequence, weights: Optional[Sequence[float]] = None,
                 seed: int = 12345):
        self.datasets = list(datasets)
        n = len(self.datasets)
        if weights is None:
            weights = [1.0 / n] * n
        total = sum(weights)
        self.weights = [w / total for w in weights]
        self.seed = seed

    def __iter__(self):
        rng = random.Random(self.seed)
        iterators = [iter(d) for d in self.datasets]
        while iterators:
            idx = rng.choices(range(len(iterators)), weights=self.weights, k=1)[0]
            try:
                yield next(iterators[idx])
            except StopIteration:
                del iterators[idx]
                del self.weights[idx]
                if self.weights:
                    total = sum(self.weights)
                    self.weights = [w / total for w in self.weights]
