"""Evoformer pair-bias attention (K10) of the PyTorch/CUDA port against the
JAX package, on the CPU.

- K10's four plain versions (forward; dq, dk/dv and d(pair)) against the
  Pallas kernels ``_fwd`` / ``_bwd`` run in interpret mode, as
  ``tests/unit/test_evoformer_fused.py`` runs them, over that file's shape
  grid plus a ragged S = 40. Both sides compute in f32; o and lse at
  2e-5, the gradients at 2e-4 (the same products summed in another order:
  online softmax over tiles against one softmax; d(pair) sums R rows).
  The CUDA d(pair)'s order (R rows in contiguous chunks, then the chunks'
  partials in order) against the plain version at 1e-5 and the Pallas
  kernel at 2e-4.
- ``evoformer_flash_attention``'s autograd against ``jax.grad`` of JAX's,
  d(pair) included and a zero mask cotangent; the four AlphaFold modes and
  ``DS4Sci_EvoformerAttention``'s routing against JAX's outputs and
  gradients; rows whose keys are all masked (-1e30: exactly uniform, -1e9:
  near uniform) equal to JAX's kernel; the bias helpers byte-equal; an f64
  gradcheck of the autograd function.

Inputs are made with numpy from seeds and handed to both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer as jevo
from deepspeed_tpu.ops.pallas import evoformer_attention as jk10
from deepspeed_tpu_torch.ops import evoformer as tevo
from deepspeed_tpu_torch.ops.kernels import evoformer_attention as k10

from tests._torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
BWD_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


def _inputs(L, S, H, D, R, masked, seed, fill=-1e9):
    """q, k, v, dO [L, S, H, D], pair [L / R, H, S, S], mask [L, S] or None."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(L, S, H, D).astype(np.float32) for _ in range(4))
    pair = rng.randn(L // R, H, S, S).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.rand(L, S) < 0.8, 0.0, fill).astype(np.float32)
    return q, k, v, do, pair, mask


@functools.lru_cache(maxsize=None)
def _jax_kernels(scale, R, block):
    fwd = jax.jit(lambda q, k, v, m, p: jk10._fwd(q, k, v, m, p, scale, R, block))
    bwd = jax.jit(lambda q, k, v, m, p, o, lse, do: jk10._bwd(q, k, v, m, p, o, lse, do,
                                                              scale, R, block))
    return fwd, bwd


def _jax_fwd_bwd(q, k, v, do, pair, mask, R, block=16):
    """JAX's (o, lse, dq, dk, dv, dpair) in the port's layouts."""
    scale = q.shape[-1] ** -0.5
    fwd, bwd = _jax_kernels(scale, R, block)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)       # [L, H, S, D]
    jm = None if mask is None else jnp.asarray(mask)
    o, lse = fwd(sw(q), sw(k), sw(v), jm, jnp.asarray(pair))
    dq, dk, dv, dpair = bwd(sw(q), sw(k), sw(v), jm, jnp.asarray(pair), o, lse, sw(do))
    back = lambda a: np.swapaxes(np.asarray(a), 1, 2)
    return back(o), np.asarray(lse)[..., 0], back(dq), back(dk), back(dv), np.asarray(dpair)


# --------------------------------------------------------------------------- #
# (a) the four plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #

GRID = [(16, 2, 32, 1, False), (48, 2, 16, 4, True), (32, 4, 64, 2, True),
        (40, 2, 16, 2, True)]


@pytest.mark.parametrize("S,H,D,R,masked", GRID,
                         ids=[f"S{c[0]}-H{c[1]}-D{c[2]}-R{c[3]}-{'mask' if c[4] else 'nomask'}"
                              for c in GRID])
def test_plain_versions_match_pallas(S, H, D, R, masked):
    L = 2 * R
    q, k, v, do, pair, mask = _inputs(L, S, H, D, R, masked, seed=S + D)
    ref = _jax_fwd_bwd(q, k, v, do, pair, mask, R)
    scale = D ** -0.5
    tq, tk, tv, tdo, tpair = map(_t, (q, k, v, do, pair))
    tmask = None if mask is None else _t(mask)
    o, lse = k10.evoformer_fwd_plain(tq, tk, tv, tmask, tpair, scale, R)
    _close(o, ref[0], FWD_TOL)
    _close(lse, ref[1], FWD_TOL)
    delta = k10.evoformer_delta(o, tdo)
    args = (tq, tk, tv, tmask, tpair, tdo, lse, delta, scale, R)
    dq = k10.evoformer_dq_plain(*args)
    dk, dv = k10.evoformer_dkv_plain(*args)
    dpair = k10.evoformer_dbias_plain(*args)
    for got, want in zip((dq, dk, dv, dpair), ref[2:]):
        _close(got, want, BWD_TOL)
    # the wrappers take the plain versions for CPU tensors
    for got, want in zip(k10.evoformer_bwd(tq, tk, tv, tmask, tpair, o, lse, tdo, scale, R),
                         (dq, dk, dv, dpair)):
        assert torch.equal(got, want)


def _dbias_in_chunks(q, k, v, mask, pair, do, lse, delta, scale, R, chunks):
    """d(pair) in the CUDA kernel's order: each of ``chunks`` contiguous
    chunks of a group's rows summed in row order from zero, then the chunks'
    partials added in chunk order (``evoformer_dbias`` with
    ``dbias_chunks`` chunks; the plain version sums the R rows in one
    reduction)."""
    L, S, H, _ = q.shape
    p, dp = k10._probs_dp(q, k, v, mask, pair, do, lse, scale, R)
    db = p.mul_(dp.sub_(delta[..., None])).view(L // R, R, H, S, S)
    total = None
    for c in range(chunks):
        part = torch.zeros_like(db[:, 0])
        for r in range(R * c // chunks, R * (c + 1) // chunks):
            part = part + db[:, r]
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_dbias_chunk_order_matches_plain_and_pallas(chunks):
    """The chunked order against the plain version at 1e-5 (f32: the same
    terms, another order of their sum) and against the Pallas kernel at the
    gradients' tolerance, on GRID's masked R = 4 case."""
    S, H, D, R, masked = GRID[1]
    L = 2 * R
    q, k, v, do, pair, mask = _inputs(L, S, H, D, R, masked, seed=S + D)
    ref = _jax_fwd_bwd(q, k, v, do, pair, mask, R)
    scale = D ** -0.5
    tq, tk, tv, tdo, tpair, tmask = map(_t, (q, k, v, do, pair, mask))
    o, lse = k10.evoformer_fwd_plain(tq, tk, tv, tmask, tpair, scale, R)
    args = (tq, tk, tv, tmask, tpair, tdo, lse, k10.evoformer_delta(o, tdo), scale, R)
    got = _dbias_in_chunks(*args, chunks)
    _close(got, k10.evoformer_dbias_plain(*args), 1e-5)
    _close(got, ref[5], BWD_TOL)


@pytest.mark.parametrize("fill", [-1e30, -1e9])
def test_fully_masked_rows_match_pallas(fill):
    """A row whose keys are all masked is a finite bias, not an excluded
    row: p is uniform (exactly at -1e30; at -1e9 up to f32 rounding in the
    score order) and the gradients follow the same arithmetic as JAX's."""
    S, H, D, R = 32, 2, 16, 2
    q, k, v, do, pair, mask = _inputs(2 * R, S, H, D, R, True, seed=11, fill=fill)
    mask[1] = fill                                    # row 1: every key masked
    ref = _jax_fwd_bwd(q, k, v, do, pair, mask, R)
    tq, tk, tv, tdo, tpair, tmask = map(_t, (q, k, v, do, pair, mask))
    o, lse = k10.evoformer_fwd_plain(tq, tk, tv, tmask, tpair, D ** -0.5, R)
    _close(o, ref[0], FWD_TOL)
    _close(lse, ref[1], FWD_TOL)
    for got, want in zip(k10.evoformer_bwd(tq, tk, tv, tmask, tpair, o, lse, tdo,
                                           D ** -0.5, R), ref[2:]):
        _close(got, want, BWD_TOL)
    uniform = np.broadcast_to(v[1].mean(0, keepdims=True), v[1].shape)
    _close(o[1], uniform, 1e-6 if fill == -1e30 else 1e-3)


# --------------------------------------------------------------------------- #
# (b) the autograd function, the modes and the entry point against JAX's
# --------------------------------------------------------------------------- #

def _jax_vjp(fn, arrays, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(fn, arrays, g, grad_of):
    ts = [_t(a).requires_grad_(i in grad_of) for i, a in enumerate(arrays)]
    out = fn(*ts)
    out.backward(_t(g))
    return out.detach(), [ts[i].grad for i in grad_of]


def test_flash_attention_autograd_matches_jax_grad():
    """Gradients of sum(o * g) in q, k, v, mask and pair: the mask's is
    zeros on both sides; ``block`` changes nothing."""
    S, H, D, R = 32, 2, 16, 2
    q, k, v, g, pair, mask = _inputs(2 * R, S, H, D, R, True, seed=3)
    ref, ref_grads = _jax_vjp(lambda *a: jk10.evoformer_flash_attention(
        *a[:4], a[4], rows_per_group=R, block=16), (q, k, v, pair, mask), g)
    out, grads = _port_grads(lambda *a: k10.evoformer_flash_attention(
        *a[:4], a[4], rows_per_group=R), (q, k, v, pair, mask), g, range(5))
    _close(out, ref, FWD_TOL)
    for got, want in zip(grads, ref_grads):
        _close(got, want, BWD_TOL)
    assert not grads[4].any() and not ref_grads[4].any()
    ts = [_t(a) for a in (q, k, v, pair, mask)]
    assert torch.equal(k10.evoformer_flash_attention(*ts, rows_per_group=R, block=16),
                       k10.evoformer_flash_attention(*ts, rows_per_group=R, block=256))
    with pytest.raises(AssertionError):
        k10.evoformer_flash_attention(*ts[:3], ts[3][:1], ts[4], rows_per_group=R)


B, N, S, H, D = 1, 3, 16, 2, 16
MODES = {
    # name: (shapes of the differentiable inputs, mask shape, takes a pair bias)
    "msa_row_attention": ((B, N, S, H, D), (B, N, S), True),
    "msa_col_attention": ((B, N, S, H, D), (B, N, S), False),
    "triangle_attention_starting_node": ((B, S, S, H, D), (B, S, S), True),
    "triangle_attention_ending_node": ((B, S, S, H, D), (B, S, S), True),
}


@pytest.mark.parametrize("name", sorted(MODES))
def test_modes_match_jax(name):
    shape, mshape, has_pair = MODES[name]
    rng = np.random.RandomState(len(name))
    q, k, v, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    keep = (rng.rand(*mshape) < 0.8).astype(np.float32)
    arrays = [q, k, v] + ([rng.randn(B, H, S, S).astype(np.float32)] if has_pair else [])
    jfn = lambda *a: getattr(jk10, name)(*a, jnp.asarray(keep))
    tfn = lambda *a: getattr(k10, name)(*a, _t(keep))
    ref, ref_grads = _jax_vjp(jfn, arrays, g)
    out, grads = _port_grads(tfn, arrays, g, range(len(arrays)))
    _close(out, ref, FWD_TOL)
    for got, want in zip(grads, ref_grads):
        _close(got, want, BWD_TOL)


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous-in", "strided-in"])
@pytest.mark.parametrize("name", ["msa_row_attention", "triangle_attention_starting_node",
                                  "triangle_attention_ending_node"])
def test_modes_hand_the_kernels_contiguous_rows(name, strided, monkeypatch):
    """The CUDA kernels take contiguous [L, S, H, D] rows: the modes' folds
    copy transposed or strided views (B = 1 folds the ending node's
    transposed view to a strided view, not a copy)."""
    shape, mshape, _ = MODES[name]
    seen = []
    apply = k10.EvoformerAttention.apply
    monkeypatch.setattr(k10.EvoformerAttention, "apply", lambda q, k, v, *a: seen.append(
        all(t.is_contiguous() for t in (q, k, v))) or apply(q, k, v, *a))
    z = torch.randn(*shape)
    if strided:         # the same shape with axes 1 and 2 swapped in memory
        z = torch.randn(shape[0], shape[2], shape[1], *shape[3:]).transpose(1, 2)
    getattr(k10, name)(z, z, z, torch.randn(B, H, S, S), torch.ones(mshape))
    assert seen == [True]


def _ds4sci_case(case, rng):
    """(biases as numpy (None where absent), fused, expected route)."""
    bias1 = np.where(rng.rand(B, N, 1, 1, S) < 0.8, 0.0, -1e9).astype(np.float32)
    bias2 = rng.randn(B, 1, H, S, S).astype(np.float32)
    full = rng.randn(B, N, H, S, S).astype(np.float32)
    return {
        "none-pair-only": ([None, bias2], None, "fused"),
        "none-both": ([bias1, bias2], None, "reference"),
        "true-both": ([bias1, bias2], True, "fused"),
        "true-pair-only": ([None, bias2], True, "fused"),
        "false-both": ([bias1, bias2], False, "reference"),
        "none-full-bias": ([bias1, full], None, "reference"),
        "none-mask-only": ([bias1], None, "reference"),
    }[case]


@pytest.mark.parametrize("case", ["none-pair-only", "none-both", "true-both", "true-pair-only",
                                  "false-both", "none-full-bias", "none-mask-only"])
def test_ds4sci_routing_matches_jax(case, monkeypatch):
    rng = np.random.RandomState(sum(map(ord, case)))
    biases, fused, route = _ds4sci_case(case, rng)
    q, k, v, g = (rng.randn(B, N, S, H, D).astype(np.float32) for _ in range(4))
    present = [i for i, b in enumerate(biases) if b is not None]
    arrays = [q, k, v] + [biases[i] for i in present]

    def place(bs):
        out = [None] * len(biases)
        for i, b in zip(present, bs):
            out[i] = b
        return out

    calls = []
    flash = tevo.evoformer_flash_attention
    monkeypatch.setattr(tevo, "evoformer_flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    ref, ref_grads = _jax_vjp(lambda Q, K, V, *bs: jevo.DS4Sci_EvoformerAttention(
        Q, K, V, place(bs), fused=fused), arrays, g)
    out, grads = _port_grads(lambda Q, K, V, *bs: tevo.DS4Sci_EvoformerAttention(
        Q, K, V, place(bs), fused=fused), arrays, g, range(len(arrays)))
    assert len(calls) == (route == "fused")
    _close(out, ref, FWD_TOL)
    for got, want in zip(grads, ref_grads):
        _close(got, want, BWD_TOL)
    if route == "fused" and biases[0] is not None:
        assert not grads[3].any()                     # the mask is a constant


def test_ds4sci_refuses_what_jax_refuses():
    t = torch.zeros(B, N, S, H, D)
    bias2 = torch.zeros(B, 1, H, S, S)
    with pytest.raises(ValueError, match="at most 2 biases"):
        tevo.DS4Sci_EvoformerAttention(t, t, t, [None, bias2, bias2])
    for bad in ([torch.zeros(B, N, S), bias2], [None, torch.zeros(B, N, H, S, S)], [None]):
        with pytest.raises(ValueError, match="fused=True"):
            tevo.DS4Sci_EvoformerAttention(t, t, t, bad, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        tevo.DS4Sci_EvoformerAttention(t[0], t[0], t[0], [None, bias2], fused=True)


def test_bias_helpers_byte_equal_to_jax():
    rng = np.random.RandomState(7)
    mask = (rng.rand(2, 3, 16) < 0.7).astype(np.float32)
    got = tevo.msa_row_attention_mask_bias(_t(mask)).numpy()
    want = np.asarray(jevo.msa_row_attention_mask_bias(jnp.asarray(mask)))
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 3, 1, 1, 16)
    assert got.tobytes() == want.tobytes()
    # multiples of 1/8 below 4 in magnitude: every product and sum is exact
    # in f32, whatever order either einsum takes
    z = (rng.randint(-32, 32, (2, 12, 12, 8)) / 8).astype(np.float32)
    proj = (rng.randint(-32, 32, (8, 4)) / 8).astype(np.float32)
    got = tevo.triangle_pair_bias(_t(z), 4, _t(proj)).numpy()
    want = np.asarray(jevo.triangle_pair_bias(jnp.asarray(z), 4, jnp.asarray(proj)))
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 1, 4, 12, 12)
    assert got.tobytes() == want.tobytes()


def test_evoformer_autograd_gradcheck_f64():
    """The autograd function's backward (plain versions on the CPU) is the
    derivative of its forward in q, k, v and pair, in f64 at a tiny ragged
    shape: S = 5, two groups of two rows, a few masked keys."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(4, 5, 2, 3)).requires_grad_() for _ in range(3))
    pair = torch.from_numpy(rng.randn(2, 2, 5, 5)).requires_grad_()
    mask = torch.from_numpy(np.where(rng.rand(4, 5) < 0.7, 0.0, -1e9))
    fn = lambda a, b, c, p: k10.EvoformerAttention.apply(a, b, c, mask, p, 0.5, 2)
    assert torch.autograd.gradcheck(fn, (q, k, v, pair))
