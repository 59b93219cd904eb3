"""The port's native host tier (``deepspeed_tpu_torch/ops/native``) against
the JAX package's (CPU): the C++ source, the host optimizer kernels, the
fp32 <-> bf16 conversions and the AIO handle.

Tolerances: none. The port compiles a byte-equal copy of the JAX
package's ``ds_native.cpp`` with the same flags, and its numpy plain
versions are the JAX package's numpy branch, so every comparison is bit
for bit.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.native import cpu_optimizer as jax_opt
from deepspeed_tpu_torch.ops.native import (AsyncIOHandle, HostAdagrad, HostAdam, HostLion,
                                            aligned_empty, bf16_to_f32, builder, f32_to_bf16,
                                            swap_in_tensors, swap_out_tensors)

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CPP = os.path.join(ROOT, "deepspeed_tpu", "ops", "native", "csrc", "ds_native.cpp")


def test_native_source_is_the_jax_packages_byte_for_byte():
    with open(JAX_CPP, "rb") as a, open(builder.SRC, "rb") as b:
        assert a.read() == b.read()


def _arrays(seed, n, k):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _jax_kernel(name, numpy_branch, **kw):
    cls = {"adam": jax_opt.HostAdam, "lion": jax_opt.HostLion,
           "adagrad": jax_opt.HostAdagrad}[name]
    k = cls(**kw)
    if numpy_branch:
        k._lib = None   # the JAX package's numpy branch, reached on the instance
    else:
        assert k.backend == "openmp"
    return k


def _port_kernel(name, backend, **kw):
    cls = {"adam": HostAdam, "lion": HostLion, "adagrad": HostAdagrad}[name]
    k = cls(backend=backend, **kw)
    assert k.backend == backend
    return k


CASES = [
    ("adam", dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, adamw_mode=True), 2),
    ("adam", dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.1, adamw_mode=False), 2),
    ("adam", dict(lr=3e-3, weight_decay=0.0, bias_correction=False), 2),
    ("lion", dict(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.1), 1),
    ("adagrad", dict(lr=1e-2, eps=1e-10, weight_decay=0.01), 1),
]


@pytest.mark.parametrize("backend", ["openmp", "numpy"])
@pytest.mark.parametrize("name, kw, n_states", CASES,
                         ids=["adamw", "adam-l2", "adam-nobc", "lion", "adagrad"])
def test_host_kernels_bitwise_equal_to_the_jax_packages(backend, name, kw, n_states):
    """Three steps on the same seeded arrays: the port's openmp kernel
    against the JAX package's native one, and the port's numpy plain
    version against the JAX package's numpy branch."""
    n = 10007
    p0, *states0 = _arrays(0, n, 1 + n_states)
    states0 = [np.abs(s) if i == n_states - 1 and name != "lion" else s
               for i, s in enumerate(states0)]
    ours = _port_kernel(name, backend, **kw)
    ref = _jax_kernel(name, backend == "numpy", **kw)
    p_a, p_b = p0.copy(), p0.copy()
    s_a, s_b = [s.copy() for s in states0], [s.copy() for s in states0]
    for step in range(1, 4):
        g = _arrays(step, n, 1)[0]
        lr = kw["lr"] * step / 3
        ours.step(step, p_a, g, *s_a, lr=lr)
        ref.step(step, p_b, g, *s_b, lr=lr)
    assert p_a.tobytes() == p_b.tobytes()
    for a, b in zip(s_a, s_b):
        assert a.tobytes() == b.tobytes()


def test_numpy_plain_version_runs_only_by_name(monkeypatch):
    """The default backend is the native one; an unknown name raises; a
    failing build raises rather than falling back to numpy."""
    assert HostAdam().backend == "openmp"
    with pytest.raises(ValueError, match="backend"):
        HostAdam(backend="python")

    def broken():
        raise builder.NativeBuildError("g++ failed")

    monkeypatch.setattr("deepspeed_tpu_torch.ops.native.cpu_optimizer.load_native", broken)
    with pytest.raises(builder.NativeBuildError):
        HostLion()
    assert HostLion(backend="numpy").backend == "numpy"


SPECIAL = np.array([0x7FC00001, 0xFFC00001, 0x7F800001, 0xFF812345, 0x3F808000, 0x3F818000,
                    0x3F808001, 0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x00008000, 0x80018000,
                    0x00000001, 0x80000000], np.uint32)


@pytest.mark.parametrize("backend", ["openmp", "numpy"])
def test_bf16_conversions_bitwise_equal_to_the_jax_packages(backend):
    x = np.concatenate([SPECIAL.view(np.float32),
                        np.random.default_rng(3).standard_normal(4099).astype(np.float32)])
    ours = f32_to_bf16(x, backend=backend)
    if backend == "numpy":
        monkey = jax_opt.load_native
        try:
            jax_opt.load_native = lambda: None
            ref = jax_opt.f32_to_bf16(x)
            back_ref = jax_opt.bf16_to_f32(ref)
        finally:
            jax_opt.load_native = monkey
    else:
        ref = jax_opt.f32_to_bf16(x)
        back_ref = jax_opt.bf16_to_f32(ref)
    assert ours.tobytes() == ref.tobytes()
    back = bf16_to_f32(ours, backend=backend)
    assert back.tobytes() == back_ref.tobytes()
    # finite values round to nearest even as ml_dtypes does (the JAX
    # engine's astype); bf16 -> f32 is exact
    finite = np.isfinite(x)
    assert ours[finite].tobytes() == x[finite].astype(ml_dtypes.bfloat16).view(np.uint16).tobytes()
    assert back.view(np.uint32).tobytes() == (ours.astype(np.uint32) << 16).tobytes()


def _round_trip(handle, tmp_path, nbytes, offset=0):
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, nbytes, dtype=np.uint8)
    path = str(tmp_path / f"blob_{nbytes}_{offset}.bin")
    if offset:
        with open(path, "wb") as f:
            f.write(b"\0" * offset)
    assert handle.async_pwrite(src, path, offset) == 0
    assert handle.wait() == 1
    dst = np.zeros_like(src)
    assert handle.sync_pread(dst, path, offset) == 0
    np.testing.assert_array_equal(src, dst)


@pytest.mark.parametrize("nbytes", [17, 4096, 1 << 20, (1 << 20) + 13])
def test_aio_round_trip_sizes(tmp_path, nbytes):
    h = AsyncIOHandle(block_size=64 * 1024, thread_count=4)
    try:
        _round_trip(h, tmp_path, nbytes)
    finally:
        h.close()


def test_aio_offsets_many_inflight_and_o_direct(tmp_path):
    h = AsyncIOHandle(block_size=4096, thread_count=4, use_o_direct=True)
    try:
        _round_trip(h, tmp_path, 5000, offset=4096)
        arrs = [np.full(10000, i, np.uint8) for i in range(10)]
        paths = [str(tmp_path / f"t{i}.bin") for i in range(10)]
        swap_out_tensors(h, arrs, paths)
        assert h.wait() == 10
        outs = [np.zeros(10000, np.uint8) for _ in range(10)]
        swap_in_tensors(h, outs, paths)
        assert h.wait() == 10
        assert all((o == i).all() for i, o in enumerate(outs))
        src = aligned_empty(64 * 4096, np.uint8)
        assert src.ctypes.data % 4096 == 0
        src[:] = np.random.default_rng(0).integers(0, 256, src.size, dtype=np.uint8)
        assert h.async_pwrite(src, str(tmp_path / "direct.bin")) == 0 and h.wait() == 1
        dst = aligned_empty(64 * 4096, np.uint8)
        assert h.sync_pread(dst, str(tmp_path / "direct.bin")) == 0
        np.testing.assert_array_equal(src, dst)
        buf = np.zeros(16, np.uint8)
        rc = h.async_pread(buf, str(tmp_path / "missing.bin"))
        assert rc != 0 or h.wait() < 0
        assert h.inflight() == 0
    finally:
        h.close()


def test_aio_fault_sites_surface(tmp_path):
    from deepspeed_tpu_torch.utils import fault_injection
    h = AsyncIOHandle(thread_count=2)
    src = np.arange(100, dtype=np.uint8)
    try:
        fault_injection.install(fault_injection.parse_plan(
            "aio.write:at=1:action=errno:errno=5;aio.wait:at=1:action=errno:errno=28"))
        assert h.async_pwrite(src, str(tmp_path / "a.bin")) == -5
        assert h.async_pwrite(src, str(tmp_path / "a.bin")) == 0
        assert h.wait() == -28   # after the real drain
        assert h.inflight() == 0
    finally:
        fault_injection.clear()
        h.close()


def test_failed_build_raises_with_the_compilers_text(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( { this is not C++ }\n")
    with pytest.raises(builder.NativeBuildError) as e:
        builder.compile_native(src=str(bad), out=str(tmp_path / "lib.so"))
    assert "error" in str(e.value)
    assert not (tmp_path / "lib.so").exists()


def test_build_lands_in_the_ignored_build_dir():
    lib = builder.load_native()
    assert lib is builder.load_native()
    path = builder._lib_path()
    assert os.path.exists(path) and path.startswith(builder.BUILD_ROOT)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "deepspeed_tpu_torch/ops/native/_build/" in f.read().split()
    assert os.path.relpath(builder.BUILD_ROOT, ROOT) == os.path.join(
        "deepspeed_tpu_torch", "ops", "native", "_build")
    assert torch.get_num_threads() == 1   # the file's one-thread fixture
