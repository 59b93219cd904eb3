"""Host optimizer steps over numpy fp32 buffers (the JAX package's
``ops/native/cpu_optimizer.py``): ``HostAdam``, ``HostAdagrad``,
``HostLion`` and the fp32 <-> bf16 conversions.

The offload tier steps the fp32 master and the moments where they live, in
host RAM (or swapped in from disk), with the OpenMP kernels of
``csrc/ds_native.cpp``. Each class also keeps the JAX package's numpy
version of the same math, the plain version of the C++ path; it runs only
when the caller asks for it by name (``backend="numpy"``), never as a
fallback: ``backend="openmp"`` (the default) builds the library at first
use and raises when it cannot.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.ops.native.builder import load_native

BACKENDS = ("openmp", "numpy")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(name: str, *arrays: np.ndarray) -> None:
    for a in arrays:
        if a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]:
            raise ValueError(f"{name}: buffers must be contiguous float32")
        if a.size != arrays[0].size:
            raise ValueError(
                f"{name}: buffer size mismatch ({a.size} vs {arrays[0].size}); "
                "params/grads/states must be the same flat length")


def _library(backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"unknown host kernel backend {backend!r}; known: {BACKENDS}")
    return load_native() if backend == "openmp" else None


class _HostKernelBase:
    @property
    def backend(self) -> str:
        """Which implementation runs: ``"openmp"`` (the C++ kernels) or
        ``"numpy"`` (the plain version, by request)."""
        return "openmp" if self._lib is not None else "numpy"


class HostAdam(_HostKernelBase):
    """In-place Adam/AdamW step on host buffers: p, m, v mutated; g read-only."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True, backend: str = "openmp"):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.bias_correction = bias_correction
        self._lib = _library(backend)

    def step(self, step_num: int, params: np.ndarray, grads: np.ndarray,
             exp_avg: np.ndarray, exp_avg_sq: np.ndarray,
             lr: Optional[float] = None) -> None:
        _check("HostAdam", params, grads, exp_avg, exp_avg_sq)
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        if self.bias_correction:
            bc1 = 1.0 - b1 ** step_num
            bc2 = 1.0 - b2 ** step_num
        else:
            bc1 = bc2 = 1.0
        if self._lib is not None:
            self._lib.ds_adam_step(
                params.size, _ptr(params), _ptr(grads), _ptr(exp_avg),
                _ptr(exp_avg_sq), lr, b1, b2, self.eps, self.weight_decay,
                1 if self.adamw_mode else 0, bc1, bc2)
            return
        g = grads
        if not self.adamw_mode and self.weight_decay > 0.0:
            g = g + self.weight_decay * params
        exp_avg *= b1
        exp_avg += (1.0 - b1) * g
        exp_avg_sq *= b2
        exp_avg_sq += (1.0 - b2) * g * g
        denom = np.sqrt(exp_avg_sq / bc2) + self.eps
        upd = (exp_avg / bc1) / denom
        if self.adamw_mode and self.weight_decay > 0.0:
            upd = upd + self.weight_decay * params
        params -= np.float32(lr) * upd


class HostAdagrad(_HostKernelBase):
    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, backend: str = "openmp"):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self._lib = _library(backend)

    def step(self, step_num: int, params: np.ndarray, grads: np.ndarray,
             exp_avg_sq: np.ndarray, lr: Optional[float] = None) -> None:
        _check("HostAdagrad", params, grads, exp_avg_sq)
        lr = self.lr if lr is None else lr
        if self._lib is not None:
            self._lib.ds_adagrad_step(params.size, _ptr(params), _ptr(grads),
                                      _ptr(exp_avg_sq), lr, self.eps,
                                      self.weight_decay)
            return
        g = grads
        if self.weight_decay > 0.0:
            g = g + self.weight_decay * params
        exp_avg_sq += g * g
        params -= np.float32(lr) * g / (np.sqrt(exp_avg_sq) + self.eps)


class HostLion(_HostKernelBase):
    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0, backend: str = "openmp"):
        self.lr = lr
        self.betas = tuple(betas)
        self.weight_decay = weight_decay
        self._lib = _library(backend)

    def step(self, step_num: int, params: np.ndarray, grads: np.ndarray,
             exp_avg: np.ndarray, lr: Optional[float] = None) -> None:
        _check("HostLion", params, grads, exp_avg)
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        if self._lib is not None:
            self._lib.ds_lion_step(params.size, _ptr(params), _ptr(grads),
                                   _ptr(exp_avg), lr, b1, b2, self.weight_decay)
            return
        c = b1 * exp_avg + (1.0 - b1) * grads
        params -= np.float32(lr) * (np.sign(c) + self.weight_decay * params)
        exp_avg *= b2
        exp_avg += (1.0 - b2) * grads


def _check_dst(name: str, dst: np.ndarray, dtype, size: int) -> None:
    if dst.dtype != dtype or not dst.flags["C_CONTIGUOUS"] or dst.size != size:
        raise ValueError(f"{name}: dst must be contiguous {dtype} of {size} elements")


def f32_to_bf16(src: np.ndarray, dst: Optional[np.ndarray] = None,
                backend: str = "openmp") -> np.ndarray:
    """Round-to-nearest-even fp32 -> bf16 (as the uint16 bit pattern); a NaN
    stays a NaN (its high bits with the quiet bit set)."""
    src = np.ascontiguousarray(src, np.float32)
    if dst is None:
        dst = np.empty(src.shape, np.uint16)
    else:
        _check_dst("f32_to_bf16", dst, np.uint16, src.size)
    lib = _library(backend)
    if lib is not None:
        lib.ds_f32_to_bf16(src.size, _ptr(src), dst.ctypes.data_as(ctypes.c_void_p))
        return dst
    bits = src.view(np.uint32)
    rounding = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    out = ((bits + rounding) >> np.uint32(16)).astype(np.uint16)
    nan = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    nan &= (bits & np.uint32(0x007FFFFF)) != 0
    if nan.any():  # rounding would carry a NaN mantissa into the exponent
        out[nan] = ((bits[nan] >> np.uint32(16)) | np.uint32(0x0040)).astype(np.uint16)
    dst.reshape(-1)[:] = out.reshape(-1)
    return dst


def bf16_to_f32(src: np.ndarray, dst: Optional[np.ndarray] = None,
                backend: str = "openmp") -> np.ndarray:
    """bf16 (the uint16 bit pattern) -> fp32, exactly."""
    src = np.ascontiguousarray(src, np.uint16)
    if dst is None:
        dst = np.empty(src.shape, np.float32)
    else:
        _check_dst("bf16_to_f32", dst, np.float32, src.size)
    lib = _library(backend)
    if lib is not None:
        lib.ds_bf16_to_f32(src.size, _ptr(src), dst.ctypes.data_as(ctypes.c_void_p))
        return dst
    dst.view(np.uint32).reshape(-1)[:] = src.astype(np.uint32).reshape(-1) << np.uint32(16)
    return dst
