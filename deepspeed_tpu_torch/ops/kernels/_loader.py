"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``deepspeed_tpu_torch/csrc/*.cu``, each with a plain C entry
point. At first use :func:`load_library` compiles every source with ``nvcc``
for ``sm_90a`` (one compiler process per source, all started together),
links them into ONE shared library under ``_build/<hash of the sources>/``
and loads it with ``ctypes``. A later process with unchanged sources loads
the library it finds there. Nothing is built at import time, and a failed
build raises with nvcc's stderr.

Each kernel wrapper adds one to :data:`LAUNCHES` ``[name]`` when it launches
its kernel, and nowhere else; :func:`reset_launches` sets every count to 0.
A kernel that runs at several split counts (K7) counts each under its own
name (``paged_splitk/8``); a launch over an int8 pool counts under the
kernel's ``_int8`` name (``paged_decode_int8``, ``paged_splitk_int8/4``);
a launch with a sliding window under its ``_window`` name
(``flash_packed_window``, ``paged_splitk_window/4``,
``paged_chunk_int8_window``), one of K2 with its lse output under its
``_lse`` name (``flash_packed_lse``, ``flash_packed_window_lse``), one with ALiBi under its ``_alibi`` name
(``paged_decode_alibi``, ``paged_splitk_int8_alibi/2``; both:
``paged_decode_window_alibi``), and a decode launch with more than one
side row (a burst's side buffer) under its ``_side`` name before those
(``paged_decode_side``, ``paged_decode_int8_side_window``,
``paged_splitk_side_window/4``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_packed.cu", "paged_chunk.cu", "paged_decode.cu", "flash_fwd.cu",
           "flash_bwd.cu", "paged_splitk.cu", "quantized_matmul.cu",
           "block_sparse_fwd.cu", "block_sparse_bwd.cu", "evoformer_fwd.cu",
           "evoformer_bwd.cu")
HEADERS = ("attn_common.cuh", "decode_common.cuh",
           "evoformer_common.cuh", "mma_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (argtypes), all return the launch's cudaError_t as int
ENTRY_POINTS = {
    "dstorch_flash_packed_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "dstorch_flash_packed_attrs": (_I, _P),
    "dstorch_paged_chunk_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _P),
    "dstorch_paged_decode_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dstorch_flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "dstorch_flash_bwd_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _P),
    "dstorch_flash_bwd_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _F, _I, _P),
    "dstorch_paged_chunk_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _P),
    "dstorch_paged_decode_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dstorch_paged_chunk_attrs": (_I, _I, _I, _I, _P),
    "dstorch_paged_decode_attrs": (_I, _I, _I, _P),
    "dstorch_paged_splitk_attrs": (_I, _I, _I, _P),
    "dstorch_paged_splitk_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "dstorch_paged_splitk_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "dstorch_splitk_merge": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dstorch_qmm_gemv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dstorch_qmm_gemv_int4": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "dstorch_qmm_gemv_attrs": (_I, _I, _P),
    "dstorch_qmm_mma": (_P, _P, _P, _P, _I, _I, _I, _P),
    "dstorch_qmm_mma_tiled": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dstorch_qmm_mma_attrs": (_I, _P),
    "dstorch_qmm_gemv_grouped": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "dstorch_qmm_mma_grouped": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "dstorch_qmm_grouped_attrs": (_I, _P),
    "dstorch_block_sparse_fwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _F, _I, _P),
    "dstorch_block_sparse_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _F, _I, _P),
    "dstorch_block_sparse_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _F, _I, _P),
    "dstorch_evoformer_fwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                   _P),
    "dstorch_evoformer_dq_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _P),
    "dstorch_evoformer_dkv_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _F, _I, _P),
    "dstorch_evoformer_dbias_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _F, _I, _P),
    "dstorch_flash_kernel_attrs": (_I, _I, _P),
    "dstorch_block_sparse_fwd_attrs": (_I, _P),
    "dstorch_block_sparse_bwd_attrs": (_I, _I, _P),
    "dstorch_evoformer_fwd_attrs": (_I, _I, _P),
    "dstorch_evoformer_bwd_attrs": (_I, _I, _I, _P),
}

LAUNCHES: Dict[str, int] = {"flash_packed": 0, "paged_chunk": 0,
                            "paged_decode": 0, "flash_packed_window": 0,
                            "flash_packed_lse": 0, "flash_packed_window_lse": 0,
                            "paged_chunk_window": 0, "paged_decode_window": 0,
                            "paged_chunk_alibi": 0, "paged_decode_alibi": 0,
                            "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "paged_chunk_int8": 0, "paged_decode_int8": 0,
                            "splitk_merge": 0, "quantized_matmul_gemv": 0,
                            "quantized_matmul_gemv_int4": 0,
                            "quantized_matmul_mma": 0,
                            "quantized_matmul_grouped_gemv": 0,
                            "quantized_matmul_grouped_mma": 0, "block_sparse_fwd": 0,
                            "block_sparse_dq": 0, "block_sparse_dkv": 0,
                            "evoformer_fwd": 0, "evoformer_dq": 0, "evoformer_dkv": 0,
                            "evoformer_dbias": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
last_build_seconds: Optional[float] = None
H100_SMS = 132
_sms: Dict[torch.device, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sm_count(device: torch.device) -> int:
    """The device's SM count (cached); the H100's 132 for a CPU device."""
    if device.type != "cuda":
        return H100_SMS
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from deepspeed_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{err}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def build_library() -> Path:
    """Compile and link the kernels (if this source hash has no library
    yet); returns the library's path."""
    global last_build_seconds
    import time
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libdstorch_kernels.so"
    if lib_path.exists():
        last_build_seconds = 0.0
        return lib_path
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / s),
                   "-o", o] for s, o in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, lib_path.name)
        _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, lib_path)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream; raise when the
    launch reports an error, else count one launch of ``kernel``."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed "
                           f"({'unsupported shape' if rc == -1 else f'cudaError {rc}'})")
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def check_cuda(kernel: str, dtype: torch.dtype, f32: Tuple[str, ...] = (),
               i8: Tuple[str, ...] = (), **tensors: torch.Tensor) -> None:
    """The kernels take contiguous, 16-byte aligned tensors on one CUDA
    device: ``dtype`` for the floating ones (float32 for those named in
    ``f32``), int8 for those named in ``i8``, int32 for indices. Raise on
    anything else."""
    if dtype != torch.bfloat16:
        raise TypeError(f"{kernel}: the CUDA kernel takes bfloat16, got {dtype}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{kernel}: all tensors must lie on one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for name, t in tensors.items():
        want = torch.float32 if name in f32 else torch.int8 if name in i8 else (
            dtype if t.is_floating_point() else torch.int32)
        if t.dtype != want:
            raise TypeError(f"{kernel}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start on a 16-byte boundary")


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when all lie on CUDA devices; raises on a mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{kernel}: tensors on {sorted(kinds)}; the kernel runs on "
                     "CUDA and its plain version on the CPU")


def window_arg(window: Optional[int]) -> int:
    """The kernels' ``window`` argument: the sliding window's span (>= 1),
    or 0 for none."""
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    return int(window)


def variant(name: str, window: Optional[int], alibi: bool) -> str:
    """A kernel's launch-count name for its branches: ``name`` plus
    ``_window`` under a sliding window and ``_alibi`` with ALiBi."""
    return name + ("_window" if window is not None else "") + ("_alibi" if alibi else "")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())
