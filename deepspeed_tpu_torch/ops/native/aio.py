"""Async tensor file I/O (the JAX package's ``ops/native/aio.py``).

``AsyncIOHandle`` submits reads and writes of numpy buffers to the C++
thread pool of ``csrc/ds_native.cpp`` (each request split into
``block_size`` chunks of pread/pwrite, O_DIRECT when the request is
4096-byte aligned and ``use_o_direct`` is set) and ``wait()`` retires them
all, returning the completed count or a negative errno. ``sync_pread`` /
``sync_pwrite`` run in the caller's thread and leave the async queue
alone. The fault-injection sites ``aio.read`` / ``aio.write`` (at submit)
and ``aio.wait`` (after the real drain) are the JAX package's.

Unlike the JAX module there is no Python thread-pool fallback: the handle
builds the native library at first use and raises when it cannot.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from deepspeed_tpu_torch.ops.native.builder import load_native
from deepspeed_tpu_torch.utils import fault_injection

AIO_DEFAULT_DICT = {
    "block_size": 1 << 20,
    "queue_depth": 32,
    "thread_count": 8,
    "single_submit": False,
    "overlap_events": True,
    "use_o_direct": False,
}


def _as_byte_view(arr: np.ndarray, for_read: bool = False) -> np.ndarray:
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("AIO requires C-contiguous arrays")
    if for_read and not arr.flags.writeable:
        raise ValueError("AIO pread target buffer must be writable")
    return arr.view(np.uint8).reshape(-1)


def aligned_empty(shape, dtype=np.float32) -> np.ndarray:
    """Page-aligned uninitialised array from the native allocator
    (``ds_alloc_aligned``, freed when the array goes): buffers from here
    meet the O_DIRECT contract, so the native engine bypasses the page
    cache for whole-buffer requests."""
    import weakref
    lib = load_native()
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    ptr = lib.ds_alloc_aligned(max(nbytes, 1))
    if not ptr:
        raise MemoryError(f"ds_alloc_aligned({nbytes}) failed")
    buf = (ctypes.c_uint8 * max(nbytes, 1)).from_address(ptr)
    arr = np.frombuffer(buf, np.uint8, count=nbytes).view(dtype).reshape(shape)
    weakref.finalize(buf, lib.ds_free_aligned, ptr)
    return arr


class AsyncIOHandle:
    """Submit/wait file I/O over numpy buffers.

    ``async_pread(buffer, path)`` / ``async_pwrite(buffer, path)`` enqueue a
    request; ``wait()`` blocks until all inflight requests retire and returns
    the completed count (reference contract: callers assert
    ``n == handle.wait()``, e.g. ``runtime/swap_tensor/utils.py:21``).
    """

    def __init__(self, block_size: int = AIO_DEFAULT_DICT["block_size"],
                 queue_depth: int = AIO_DEFAULT_DICT["queue_depth"],
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = AIO_DEFAULT_DICT["thread_count"],
                 use_o_direct: bool = False):
        self._block_size = int(block_size)
        self._queue_depth = int(queue_depth)
        self._single_submit = bool(single_submit)
        self._overlap_events = bool(overlap_events)
        self._thread_count = int(thread_count)
        self._lib = load_native()
        self._keepalive: List[np.ndarray] = []
        self._handle = self._lib.ds_aio_create(
            self._block_size, self._queue_depth, self._thread_count,
            1 if use_o_direct else 0)

    # -- accessors (reference py_ds_aio.cpp binding surface) -------------- #
    def get_block_size(self) -> int:
        return self._block_size

    def get_queue_depth(self) -> int:
        return self._queue_depth

    def get_single_submit(self) -> bool:
        return self._single_submit

    def get_overlap_events(self) -> bool:
        return self._overlap_events

    def get_thread_count(self) -> int:
        return self._thread_count

    # -- submit/wait ------------------------------------------------------ #
    def async_pread(self, buffer: np.ndarray, path: str, file_offset: int = 0) -> int:
        return self._submit(buffer, path, file_offset, is_read=True)

    def async_pwrite(self, buffer: np.ndarray, path: str, file_offset: int = 0) -> int:
        return self._submit(buffer, path, file_offset, is_read=False)

    def sync_pread(self, buffer: np.ndarray, path: str, file_offset: int = 0) -> int:
        """Blocking read in the caller's thread. Deliberately does NOT touch the
        async queue: pending async requests stay pending and their completions
        are still counted by the next ``wait()`` (reference contract)."""
        return self._sync_io(buffer, path, file_offset, is_read=True)

    def sync_pwrite(self, buffer: np.ndarray, path: str, file_offset: int = 0) -> int:
        return self._sync_io(buffer, path, file_offset, is_read=False)

    def _sync_io(self, buffer: np.ndarray, path: str, file_offset: int,
                 is_read: bool) -> int:
        view = _as_byte_view(buffer, for_read=is_read)
        try:
            self._py_io(view, path, file_offset, is_read)
        except OSError as e:
            return -(e.errno or 1)
        return 0

    # reference aliases (read/write are whole-file sync ops)
    read = sync_pread
    write = sync_pwrite

    def wait(self) -> int:
        # the injected completion failure lands only AFTER the real drain:
        # whatever action fires, every in-flight request has retired and its
        # buffer is released first, so a caller's recovery path never
        # recycles memory a request still targets
        if self._handle is None:
            raise RuntimeError("AsyncIOHandle is closed")
        rc = self._lib.ds_aio_wait(self._handle)
        self._keepalive.clear()
        inj_rc = fault_injection.maybe_rc("aio.wait")
        return inj_rc if inj_rc < 0 else rc

    def inflight(self) -> int:
        return len(self._keepalive)

    def close(self):
        if self._handle is not None:
            self._lib.ds_aio_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- internals --------------------------------------------------------- #
    def _submit(self, buffer: np.ndarray, path: str, file_offset: int,
                is_read: bool) -> int:
        # injected submit failure: a clean negative rc BEFORE the request is
        # queued or the buffer pinned — exactly the shape a real submit
        # rejection has, so caller recovery paths see the true contract
        rc = fault_injection.maybe_rc("aio.read" if is_read else "aio.write")
        if rc < 0:
            return rc
        view = _as_byte_view(buffer, for_read=is_read)
        if self._handle is None:
            raise RuntimeError("AsyncIOHandle is closed")
        ptr = view.ctypes.data_as(ctypes.c_void_p)
        rc = int(self._lib.ds_aio_submit(
            self._handle, ptr, view.nbytes, path.encode(), file_offset,
            1 if is_read else 0))
        if rc == 0:
            self._keepalive.append(view)  # pinned until wait()
        return rc

    @staticmethod
    def _py_io(view: np.ndarray, path: str, file_offset: int, is_read: bool):
        mv = memoryview(view)
        if is_read:
            with open(path, "rb", buffering=0) as f:
                f.seek(file_offset)
                got = 0
                while got < view.nbytes:
                    n = f.readinto(mv[got:])
                    if not n:
                        raise OSError(5, f"short read from {path}")
                    got += n
        else:
            # O_CREAT without O_TRUNC: concurrent offset-writes to one file
            # (partitioned swap-out) must not clobber each other.
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                written = 0
                while written < view.nbytes:
                    written += os.pwrite(fd, mv[written:], file_offset + written)
            finally:
                os.close(fd)


def swap_out_tensors(handle: AsyncIOHandle, arrays, paths) -> None:
    """Enqueue writes for a list of arrays (reference swap_tensor/utils.py)."""
    for arr, path in zip(arrays, paths, strict=True):
        rc = handle.async_pwrite(arr, path)
        if rc != 0:
            raise OSError(-rc, f"async_pwrite submit failed for {path}")


def swap_in_tensors(handle: AsyncIOHandle, arrays, paths) -> None:
    for arr, path in zip(arrays, paths, strict=True):
        rc = handle.async_pread(arr, path)
        if rc != 0:
            raise OSError(-rc, f"async_pread submit failed for {path}")
