"""Memory-mapped indexed dataset (a ``.bin``/``.idx`` pair), a copy of the
JAX package's ``data/indexed_dataset.py``: numpy only, and the same bytes
on disk, so a dataset written by either package reads in the other.

A builder writes token sequences to a flat binary file plus an index of
(dtype, sizes, pointers, document index); the mmap reader serves O(1)
random access without loading the corpus.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Sequence

import numpy as np

_MAGIC = b"DSTPUIDX"
_VERSION = 1

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
           5: np.int64, 6: np.float32, 7: np.float64, 8: np.uint16}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Streaming writer (parity: ``MMapIndexedDatasetBuilder``)."""

    def __init__(self, prefix: str, dtype=np.int32):
        self._prefix = prefix
        self._dtype = np.dtype(dtype)
        self._data = open(data_file_path(prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]):
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self):
        self._doc_idx.append(len(self._sizes))

    def finalize(self):
        self._data.close()
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<QB", _VERSION, _DTYPE_CODES[self._dtype]))
            sizes = np.asarray(self._sizes, dtype=np.int64)
            pointers = np.zeros(len(sizes) + 1, dtype=np.int64)
            np.cumsum(sizes * self._dtype.itemsize, out=pointers[1:])
            doc_idx = np.asarray(self._doc_idx, dtype=np.int64)
            f.write(struct.pack("<QQ", len(sizes), len(doc_idx)))
            f.write(sizes.tobytes())
            f.write(pointers[:-1].tobytes())
            f.write(doc_idx.tobytes())


class MMapIndexedDataset:
    """mmap reader (parity: ``MMapIndexedDataset``). ``ds[i]`` returns the i-th
    sequence as a numpy view; ``get(i, offset, length)`` slices within it."""

    def __init__(self, prefix: str):
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{index_file_path(prefix)}: bad magic {magic!r}")
            version, dtype_code = struct.unpack("<QB", f.read(9))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            self._dtype = np.dtype(_DTYPES[dtype_code])
            n_seqs, n_docs = struct.unpack("<QQ", f.read(16))
            self.sizes = np.frombuffer(f.read(8 * n_seqs), dtype=np.int64)
            self._pointers = np.frombuffer(f.read(8 * n_seqs), dtype=np.int64)
            self.doc_idx = np.frombuffer(f.read(8 * n_docs), dtype=np.int64)
        self._bin = np.memmap(data_file_path(prefix), dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.get(i)

    def get(self, i: int, offset: int = 0, length: int = None) -> np.ndarray:
        size = int(self.sizes[i])
        if length is None:
            length = size - offset
        if offset < 0 or offset + length > size:
            raise IndexError(f"slice [{offset}:{offset + length}] out of "
                             f"sequence {i} of size {size}")
        start = int(self._pointers[i]) + offset * self._dtype.itemsize
        nbytes = length * self._dtype.itemsize
        return np.frombuffer(self._bin[start:start + nbytes], dtype=self._dtype)

    @property
    def supports_prefetch(self) -> bool:
        return False  # mmap: the OS page cache is the prefetcher


def make_builder(prefix: str, impl: str = "mmap", dtype=np.int32):
    """Parity: ``make_builder`` factory."""
    if impl != "mmap":
        raise ValueError(f"only mmap impl supported, got {impl}")
    return MMapIndexedDatasetBuilder(prefix, dtype=dtype)


def make_dataset(prefix: str, impl: str = "mmap"):
    if impl != "mmap":
        raise ValueError(f"only mmap impl supported, got {impl}")
    return MMapIndexedDataset(prefix)
