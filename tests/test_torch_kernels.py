"""Each kernel's plain PyTorch version (deepspeed_tpu_torch.ops.kernels)
against the JAX package's Pallas kernel, run in interpret mode on the CPU as
the JAX package's own tests run it. Inputs are made with numpy from a seed;
both sides compute in f32.

Tolerance: 2e-5 absolute on outputs of magnitude <= ~3 — the two sides
accumulate the same f32 products in a different order (flash blocks vs one
softmax), a few ulps of f32. K1's gradients: 5e-5 (K1_BWD_ATOL)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import _fwd as jax_flash_fwd
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_packed as jax_packed
from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_chunk_attention_batched as jax_chunk,
    paged_decode_attention as jax_decode,
    paged_decode_attention_sidebuf as jax_sidebuf,
    paged_decode_attention_step as jax_step)
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.ops.kernels import (flash_attention, flash_attention_fwd_plain,
                                             flash_attention_packed_plain,
                                             paged_chunk_attention_batched_plain,
                                             paged_decode_attention_plain)

from tests._torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=ATOL)


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pool_and_tables(rng, ctxs, NB, Hkv, bs, D, MB):
    """A pool of random pages and block tables giving each row its own
    pages (unused entries 0)."""
    pool = _f(rng, NB, 2, Hkv, bs, D)
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    used = 0
    for i, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[i, :n] = perm[used:used + n]
        used += n
    return pool, bt


@pytest.mark.parametrize("D", [16, 96, 128])
def test_packed_prefill_matches_k2(D):
    """GQA 4/2, R = 100 (not a multiple of 128), three segments plus
    padding rows (segment -1)."""
    rng = np.random.RandomState(D)
    R, H, Hkv = 100, 4, 2
    q, k, v = _f(rng, R, H, D), _f(rng, R, Hkv, D), _f(rng, R, Hkv, D)
    seg = np.full((R,), -1, np.int32)
    seg[:40], seg[40:71], seg[71:95] = 0, 1, 2
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    port = flash_attention_packed_plain(_t(q), _t(k), _t(v), _t(seg))
    # padding rows' outputs are never read; compare the segments' rows
    _close(port[:95], np.asarray(ref)[:95])


@pytest.mark.parametrize("D", [16, 96, 128])
def test_paged_chunk_matches_k5(D):
    """Several slots with q_start > 0 (continuation chunks), one slot
    starting at 0, one empty slot (ctx 0 -> zeros)."""
    rng = np.random.RandomState(D + 1)
    NC, Cs, H, Hkv, bs, MB = 4, 8, 4, 2, 16, 4
    ctxs = [40, 8, 21, 0]
    q0 = np.array([32, 0, 13, 0], np.int32)
    pool, bt = _pool_and_tables(rng, ctxs, 12, Hkv, bs, D, MB)
    q = _f(rng, NC, Cs, H, D)
    ctx = np.array(ctxs, np.int32)
    ref = jax_chunk(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                    jnp.asarray(q0), jnp.asarray(ctx))
    port = paged_chunk_attention_batched_plain(_t(q), _t(pool), _t(bt), _t(q0), _t(ctx))
    _close(port, ref)
    assert float(port[3].abs().max()) == 0.0


@pytest.mark.parametrize("D", [16, 128], ids=["smalld-path", "manual-dma-path"])
def test_paged_decode_matches_k3(D):
    """ctx-0 rows give zeros; partial last pages."""
    rng = np.random.RandomState(D + 2)
    S, H, Hkv, bs, MB = 4, 4, 2, 16, 4
    ctxs = [37, 0, 16, 5]
    pool, bt = _pool_and_tables(rng, ctxs, 10, Hkv, bs, D, MB)
    q = _f(rng, S, H, D)
    ctx = np.array(ctxs, np.int32)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(ctx))
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(ctx))
    _close(port, ref)
    assert float(port[1].abs().max()) == 0.0


@pytest.mark.parametrize("D", [16, 128])
def test_decode_step_matches_k4(D):
    """The fused step: output over pages [0, ctx-1) + the current token
    from registers, and the pool after the current token's write."""
    rng = np.random.RandomState(D + 3)
    S, H, Hkv, bs, MB = 3, 4, 2, 16, 4
    ctxs = [33, 1, 16]
    pool, bt = _pool_and_tables(rng, ctxs, 8, Hkv, bs, D, MB)
    q, kn, vn = _f(rng, S, H, D), _f(rng, S, Hkv, D), _f(rng, S, Hkv, D)
    ctx = np.array(ctxs, np.int32)
    ref_out, ref_pool = jax_step(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(ctx))
    pool_t = _t(pool.copy())
    port = AttentionKernelSpec(None).decode_step(_t(q), _t(kn), _t(vn), pool_t,
                                                 _t(bt), _t(ctx))
    _close(port, ref_out)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(ref_pool))


@pytest.mark.parametrize("C, j, H, Hkv", [(1, 0, 16, 8), (4, 0, 4, 2), (4, 2, 4, 2)])
def test_sidebuf_matches_k6(C, j, H, Hkv):
    """Frozen prefix pages + side slab rows cc <= j (the slab's rows past
    j hold garbage that must not be attended)."""
    rng = np.random.RandomState(C * 10 + j)
    S, D, bs, MB = 3, 128, 16, 4
    prefix = [20, 0, 47]
    pool, bt = _pool_and_tables(rng, prefix, 8, Hkv, bs, D, MB)
    q = _f(rng, S, H, D)
    sk, sv = _f(rng, S, C, Hkv, D), _f(rng, S, C, Hkv, D)
    pl = np.array(prefix, np.int32)
    ref = jax_sidebuf(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pl),
                      jnp.asarray(sk), jnp.asarray(sv), j)
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(pl),
                                        _t(sk.reshape(S, C * Hkv, D)),
                                        _t(sv.reshape(S, C * Hkv, D)), j)
    _close(port, ref)


# --------------------------------------------------------------------------- #
# K1: training flash attention, forward and backward
# --------------------------------------------------------------------------- #

K1_BWD_ATOL = 5e-5   # gradients sum T products of O(1) terms in both orders
K1_CASES = {   # D = 64 and Tk = T unless given
    "T256-causal": dict(T=256, H=4, Hkv=4, causal=True),
    "T256-full": dict(T=256, H=4, Hkv=4, causal=False),
    # 200 is not a multiple of 128: the JAX wrapper pads to 256
    "T200-causal": dict(T=200, H=4, Hkv=4, causal=True),
    "gqa-4-2": dict(T=256, H=4, Hkv=2, causal=True),
    # the other head dims of the CUDA kernels
    "hd128-causal": dict(T=128, H=2, Hkv=2, causal=True, D=128),
    "hd32-full": dict(T=192, H=4, Hkv=4, causal=False, D=32),
    # Tq != Tk: causal stays top-left (query i sees keys 0..i), as in Pallas
    "tq128-tk256-causal": dict(T=128, Tk=256, H=2, Hkv=2, causal=True),
    "tq256-tk128-full": dict(T=256, Tk=128, H=2, Hkv=2, causal=False),
}


def _k1_inputs(case):
    c = dict(K1_CASES[case])
    c.setdefault("D", 64)
    c.setdefault("Tk", c["T"])
    rng = np.random.RandomState(sorted(K1_CASES).index(case) + 11)
    B, D = 2, c["D"]
    q = _f(rng, B, c["T"], c["H"], D)
    k, v = _f(rng, B, c["Tk"], c["Hkv"], D), _f(rng, B, c["Tk"], c["Hkv"], D)
    g = _f(rng, B, c["T"], c["H"], D)
    return c, q, k, v, g


def _jax_k1(c, q, k, v):
    return functools.partial(jax_flash, causal=c["causal"], block_q=64, block_k=64)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_flash_forward_matches_k1(case):
    """o and lse of the plain forward against the Pallas forward (64-row
    blocks, so its grid has several tiles in each direction)."""
    c, q, k, v, _ = _k1_inputs(case)
    ref_o = _jax_k1(c, q, k, v)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    rep = c["H"] // c["Hkv"]
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    T, scale = c["T"], c["D"] ** -0.5
    # the JAX lse: its _fwd on [B, H, T, D], causal rows padded as the
    # public wrapper pads them (padded keys sit above every real row)
    pad = lambda a: jnp.swapaxes(jnp.pad(jnp.asarray(a), (
        (0, 0), (0, -(-a.shape[1] // 64) * 64 - a.shape[1]), (0, 0), (0, 0))), 1, 2)
    _, ref_lse = jax_flash_fwd(pad(q), pad(kr), pad(vr), scale, c["causal"], 64, 64)
    o, lse = flash_attention_fwd_plain(_t(q), _t(kr), _t(vr), c["causal"], scale)
    _close(o, ref_o)
    _close(lse, np.asarray(ref_lse)[:, :, :T, 0])
    # the public wrapper (GQA repeat inside) gives the same o
    _close(flash_attention(_t(q), _t(k), _t(v), causal=c["causal"]).detach(), ref_o)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_flash_backward_matches_k1(case):
    """dq, dk, dv of the port's autograd function (plain backward on the
    CPU; GQA reduced through the repeat) against jax.vjp of the Pallas
    kernel, on the same cotangent."""
    c, q, k, v, g = _k1_inputs(case)
    _, vjp = jax.vjp(_jax_k1(c, q, k, v), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt, causal=c["causal"]).backward(_t(g))
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=K1_BWD_ATOL)


def test_every_csrc_include_is_hashed():
    """Each ``#include "..."`` of each file under csrc/ names a header in
    ``_loader.HEADERS``, and each .cu file is in ``_loader.SOURCES``: the
    source hash, and with it the rebuild, covers every file the kernels
    compile from."""
    from deepspeed_tpu_torch.ops.kernels import _loader
    included = {}
    for path in sorted(_loader.CSRC.iterdir()):
        if path.suffix == ".cu":
            assert path.name in _loader.SOURCES, path.name
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M):
            included.setdefault(name, []).append(path.name)
    assert "mma_common.cuh" in included
    missing = {h: files for h, files in included.items() if h not in _loader.HEADERS}
    assert not missing, f"headers outside the source hash: {missing}"
    for name in _loader.SOURCES + _loader.HEADERS:
        assert (_loader.CSRC / name).is_file(), name


@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_gradcheck_f64(causal):
    """The autograd function's backward (plain versions on the CPU) is the
    derivative of its forward, in float64 at a tiny shape (GQA 2/1)."""
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, 5, 2, 4)).requires_grad_()
    k = torch.from_numpy(rng.randn(1, 5, 1, 4)).requires_grad_()
    v = torch.from_numpy(rng.randn(1, 5, 1, 4)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b, c: flash_attention(a, b, c, causal=causal),
                                    (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_and_padding_bias_match_jax(causal):
    """The dense route taken with a bias or segment ids (Tq < Tk: causal is
    bottom-right aligned there, as in the JAX package)."""
    from deepspeed_tpu.ops.attention import padding_mask_to_bias as jax_bias
    from deepspeed_tpu.ops.attention import reference_attention as jax_ref
    from deepspeed_tpu_torch.ops.attention import dot_product_attention, padding_mask_to_bias
    rng = np.random.RandomState(21)
    q, k, v = _f(rng, 2, 6, 3, 16), _f(rng, 2, 9, 3, 16), _f(rng, 2, 9, 3, 16)
    mask = (rng.rand(2, 9) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    bias = padding_mask_to_bias(_t(mask))
    np.testing.assert_array_equal(bias.numpy(), np.asarray(jax_bias(jnp.asarray(mask))))
    ref = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  bias=jnp.asarray(bias.numpy()))
    _close(dot_product_attention(_t(q), _t(k), _t(v), causal=causal, bias=bias), ref)
    seg = np.array([[0] * 4 + [1] * 5, [0] * 9], np.int32)
    qs = _f(rng, 2, 9, 3, 16)
    ref = jax_ref(jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  segment_ids=jnp.asarray(seg))
    _close(dot_product_attention(_t(qs), _t(k), _t(v), causal=causal,
                                 segment_ids=_t(seg)), ref)
