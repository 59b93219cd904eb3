"""Build and load the native host module (the JAX package's
``ops/native/builder.py``).

``csrc/ds_native.cpp`` (a copy of the JAX package's file, byte for byte)
is one C++17 translation unit with a plain C interface: the AIO thread
pool, the host Adam/Adagrad/Lion steps and the fp32 <-> bf16 conversions.
At first use :func:`load_native` compiles it with ``g++`` into
``_build/<hash of the source>/libds_native.so`` (``-march=native
-fopenmp``, falling back to ``-fopenmp``, then to neither, as the JAX
builder does) and binds it with ``ctypes``. Nothing is built at import.

Unlike the JAX loader, which returns None and lets every consumer run its
numpy path, a failed build or load raises :class:`NativeBuildError` with
g++'s stderr: the numpy versions run only where a caller asks for them by
name (``backend="numpy"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

from deepspeed_tpu_torch.utils.threads import make_lock

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ds_native.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: flag sets tried in order, as the JAX builder does
FLAG_LADDER = (("-march=native", "-fopenmp"), ("-fopenmp",), ())

_lock = make_lock("ops.native.builder")
_lib: Optional[ctypes.CDLL] = None
#: the flags the loaded library was built with (None: loaded from a cache)
built_flags: Optional[tuple] = None
#: seconds the last build took (0.0 when a cached library was loaded)
last_build_seconds = 0.0


class NativeBuildError(RuntimeError):
    """g++ could not build, or ctypes could not load, ``ds_native.cpp``."""


def _lib_path(src: str = SRC, build_root: str = BUILD_ROOT) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_root, digest, "libds_native.so")


def compile_native(src: str = SRC, out: Optional[str] = None,
                   compiler: str = "g++") -> str:
    """Compile ``src`` into ``out`` (default: the build directory's path for
    this source); returns the library's path. Each flag set of
    :data:`FLAG_LADDER` is tried in turn; when none builds, raises with the
    compiler's stderr of the last attempt."""
    global built_flags, last_build_seconds
    import time
    out = out or _lib_path(src)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # a unique temp output, published with os.replace: concurrent builds on
    # a cold cache never interleave their writes
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    t0 = time.perf_counter()
    err = ""
    try:
        for extra in FLAG_LADDER:
            cmd = [compiler, *BASE_FLAGS, *extra, src, "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(f"could not run {compiler}: {e}") from e
            if proc.returncode == 0:
                os.replace(tmp, out)
                built_flags = tuple(extra)
                last_build_seconds = time.perf_counter() - t0
                return out
            err = proc.stderr
        raise NativeBuildError(f"{compiler} failed to build {src}:\n{err[-4000:]}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ds_aio_create.restype = c.c_void_p
    lib.ds_aio_create.argtypes = [c.c_long, c.c_int, c.c_int, c.c_int]
    lib.ds_aio_destroy.argtypes = [c.c_void_p]
    lib.ds_aio_block_size.restype = c.c_long
    lib.ds_aio_block_size.argtypes = [c.c_void_p]
    lib.ds_aio_queue_depth.restype = c.c_int
    lib.ds_aio_queue_depth.argtypes = [c.c_void_p]
    lib.ds_aio_thread_count.restype = c.c_int
    lib.ds_aio_thread_count.argtypes = [c.c_void_p]
    lib.ds_aio_submit.restype = c.c_long
    lib.ds_aio_submit.argtypes = [c.c_void_p, c.c_void_p, c.c_long, c.c_char_p,
                                  c.c_long, c.c_int]
    lib.ds_aio_wait.restype = c.c_int
    lib.ds_aio_wait.argtypes = [c.c_void_p]
    lib.ds_alloc_aligned.restype = c.c_void_p
    lib.ds_alloc_aligned.argtypes = [c.c_long]
    lib.ds_free_aligned.argtypes = [c.c_void_p]
    f = c.c_float
    lib.ds_adam_step.argtypes = [c.c_long] + [c.c_void_p] * 4 + [f] * 5 + [c.c_int, f, f]
    lib.ds_adagrad_step.argtypes = [c.c_long] + [c.c_void_p] * 3 + [f] * 3
    lib.ds_lion_step.argtypes = [c.c_long] + [c.c_void_p] * 3 + [f] * 4
    lib.ds_f32_to_bf16.argtypes = [c.c_long, c.c_void_p, c.c_void_p]
    lib.ds_bf16_to_f32.argtypes = [c.c_long, c.c_void_p, c.c_void_p]
    return lib


def load_native() -> ctypes.CDLL:
    """The bound library, built at first use (a library already built for
    this source is loaded as it is). Raises :class:`NativeBuildError`."""
    global _lib, last_build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            compile_native(out=path)
        else:
            last_build_seconds = 0.0
        try:
            _lib = _bind(ctypes.CDLL(path))
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"could not load {path}: {e}") from e
        return _lib
