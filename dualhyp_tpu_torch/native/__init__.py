"""Native (C++) host ops: edit distance, DTW and the median filter.

Counterpart of `dualhyp_tpu/native/__init__.py`, with its own copy of
`hostops.cc`. The source is built at first use by `g++ -O3 -shared -fPIC
-std=c++17` into `build/dualhyp_tpu_torch/native/<hash>/` under the
checkout (a directory `.gitignore` lists), keyed by a hash of the source and
the flags, and bound with `ctypes`. The library is written under a temporary
name and renamed into place, so processes that build at once never load a
half-written file.

Where the JAX module falls back to Python without a word, this one raises
with the compiler's message: a run never carries on silently on the slow
path. The plain numpy versions the tests hold these against stay where the
port had them (`infer/whisper_timing.dtw`, `median_filter`,
`infer/evaluate.edit_distance`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "hostops.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "dualhyp_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libhostops.so"

_lock = threading.Lock()
_library: ctypes.CDLL | None = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def build() -> Path:
    """Compile `hostops.cc` if it is not built yet; return the library's
    path. Raises RuntimeError with g++'s output when the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"g++ could not run to build {SRC.name}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.edit_distance_batch.argtypes = [_i32p, _i64p, _i32p, _i64p, ctypes.c_int64,
                                                _i32p]
            lib.edit_distance_batch.restype = None
            lib.dtw.argtypes = [_f32p, ctypes.c_int32, ctypes.c_int32, _i32p, _i32p]
            lib.dtw.restype = ctypes.c_int32
            lib.median_filter.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int32, _f32p]
            lib.median_filter.restype = None
            _library = lib
    return _library


def _ptr(arr: np.ndarray, kind):
    return arr.ctypes.data_as(kind)


def edit_distance_batch(refs: Sequence[Sequence[str]],
                        hyps: Sequence[Sequence[str]]) -> np.ndarray:
    """Word-level Levenshtein distances of aligned (ref, hyp) pairs, int32."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references for {len(hyps)} hypotheses")
    vocab: dict = {}  # shared by both sides, so equal words share ids

    def encode(texts):
        flat, offsets = [], [0]
        for words in texts:
            flat.extend(vocab.setdefault(word, len(vocab)) for word in words)
            offsets.append(len(flat))
        return np.asarray(flat, np.int32), np.asarray(offsets, np.int64)

    r_flat, r_off = encode(refs)
    h_flat, h_off = encode(hyps)
    out = np.zeros(len(refs), np.int32)
    library().edit_distance_batch(_ptr(r_flat, _i32p), _ptr(r_off, _i64p), _ptr(h_flat, _i32p),
                                  _ptr(h_off, _i64p), len(refs), _ptr(out, _i32p))
    return out


def word_error_rate(predictions: Sequence[str], references: Sequence[str]) -> float:
    """Corpus WER (summed edits over summed reference words) by the batch
    kernel: the protocol of `infer.evaluate.word_error_rate`."""
    refs = [r.split() for r in references]
    dists = edit_distance_batch(refs, [p.split() for p in predictions])
    return float(dists.sum()) / max(sum(len(r) for r in refs), 1)


def dtw(cost: np.ndarray):
    """(text indices, time indices) of the cheapest monotone path through
    an (n, m) cost matrix, ties to the diagonal, then up, then left (the
    reference's dtw semantics); int32 arrays."""
    cost = np.ascontiguousarray(cost, np.float32)
    if cost.ndim != 2:
        raise ValueError(f"dtw takes an (n, m) matrix, got shape {cost.shape}")
    n, m = cost.shape
    path_i = np.zeros(n + m, np.int32)
    path_j = np.zeros(n + m, np.int32)
    length = library().dtw(_ptr(cost, _f32p), n, m, _ptr(path_i, _i32p), _ptr(path_j, _i32p))
    return path_i[:length], path_j[:length]


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Edge-replicated median filter of a 1-D array, `width` odd."""
    if width % 2 != 1:
        raise ValueError("`width` should be an odd number")
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 1:
        raise ValueError(f"median_filter takes a 1-D array, got shape {x.shape}")
    out = np.zeros_like(x)
    library().median_filter(_ptr(x, _f32p), len(x), width, _ptr(out, _f32p))
    return out
