"""Block-sparse attention (K9) of the PyTorch/CUDA port against the JAX
package, on the CPU.

- The five layout builders, ``layout_to_mask`` and ``sparsity_ratio`` are
  byte-equal to the JAX package's for the same config and seed.
- K9's plain versions (forward, and the dq and dk/dv gradients through the
  port's autograd function) against the Pallas kernel run in interpret mode,
  as ``tests/unit/test_block_sparse_pallas.py`` runs it, at that file's
  sizes (B = 1, T = 256, H = 2, D = 64, ``block_mult = 4``). Both sides
  compute in f32; tolerance atol = rtol = 2e-5 (the same products summed
  in another order: online softmax over tiles against one softmax).
- ``sparse_self_attention`` against the JAX op, which takes its dense
  route on the CPU, with and without ``key_padding_mask``/``attn_mask``.
- The kernels' host tables decode back to the token mask; an f64 gradcheck
  of the autograd function; ragged shapes (S = 1040 in blocks of 16, S =
  1056 in blocks of 32, D = 128) against a dense masked softmax in torch.

Inputs are made with numpy from seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas.block_sparse_attention import _get_bsa as jax_get_bsa
from deepspeed_tpu.ops.pallas.block_sparse_attention import (
    block_sparse_attention_bhsd as jax_bsa_bhsd)
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops import block_sparse_attention
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as k9

from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol, atol=tol)


def _qkvg(B, H, S, D, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, S, D) * 0.5).astype(np.float32) for _ in range(4)]


# --------------------------------------------------------------------------- #
# (a) layouts
# --------------------------------------------------------------------------- #

LAYOUT_CASES = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2)),
    "fixed-bi": ("FixedSparsityConfig", dict(num_heads=4, num_local_blocks=4,
                                             num_global_blocks=1)),
    "fixed-uni": ("FixedSparsityConfig", dict(num_heads=4, attention="unidirectional")),
    "fixed-per-head-4-patterns": ("FixedSparsityConfig", dict(
        num_heads=8, different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, num_different_global_patterns=4)),
    "fixed-horizontal": ("FixedSparsityConfig", dict(
        num_heads=2, num_local_blocks=8, num_global_blocks=2,
        horizontal_global_attention=True)),
    "variable-seed0": ("VariableSparsityConfig", dict(
        num_heads=4, different_layout_per_head=True, num_random_blocks=2,
        local_window_blocks=[2, 4, 8], global_block_indices=[0, 5], seed=0)),
    "variable-seed7-uni-ranges": ("VariableSparsityConfig", dict(
        num_heads=2, num_random_blocks=1, global_block_indices=[1],
        global_block_end_indices=[3], attention="unidirectional", seed=7)),
    "variable-horizontal": ("VariableSparsityConfig", dict(
        num_heads=2, horizontal_global_attention=True, global_block_indices=[2])),
    "bigbird-seed0": ("BigBirdSparsityConfig", dict(num_heads=4,
                                                    different_layout_per_head=True)),
    "bigbird-seed3-uni": ("BigBirdSparsityConfig", dict(
        num_heads=2, num_random_blocks=2, num_sliding_window_blocks=5,
        num_global_blocks=2, attention="unidirectional", seed=3)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_heads=2)),
    "bslongformer-ranges-uni": ("BSLongformerSparsityConfig", dict(
        num_heads=2, global_block_indices=[0, 9], global_block_end_indices=[2, 11],
        attention="unidirectional")),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("block", [16, 32])
def test_layouts_byte_equal_to_jax(case, block):
    name, kw = LAYOUT_CASES[case]
    S = 24 * block
    ref = getattr(jsa, name)(block=block, **kw).make_layout(S)
    got = getattr(tsa, name)(block=block, **kw).make_layout(S)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    assert tsa.layout_to_mask(got, block).tobytes() == jsa.layout_to_mask(ref, block).tobytes()
    assert tsa.sparsity_ratio(got) == jsa.sparsity_ratio(ref)


# --------------------------------------------------------------------------- #
# (b) K9's plain versions against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------- #

def _fine_row_layout():
    layout = np.zeros((1, 16, 16), np.int64)
    layout[0, :, 0] = 1           # every row sees block 0 ...
    layout[0, 5] = 0              # ... but fine row 5 sees nothing inside its
    layout[0, 4, :3] = 1          # active 64-tile (rows 4..7), row 4 more
    return layout


def _empty_rows_layout():
    layout = np.zeros((1, 16, 16), np.int64)
    layout[0, :8, :8] = 1         # second half of the rows fully masked
    return layout


def _per_head_layout():
    rng = np.random.RandomState(3)
    layout = (rng.rand(2, 16, 16) < 0.3).astype(np.int64)
    layout[:, np.arange(16), np.arange(16)] = 1
    return layout


K9_CASES = {
    "fixed-bi": lambda: (tsa.FixedSparsityConfig(num_heads=2).make_layout(256), False),
    "fixed-uni-causal": lambda: (tsa.FixedSparsityConfig(
        num_heads=2, attention="unidirectional").make_layout(256), True),
    "bigbird": lambda: (tsa.BigBirdSparsityConfig(num_heads=2).make_layout(256), False),
    "per-head": lambda: (_per_head_layout(), False),
    "masked-fine-row": lambda: (_fine_row_layout(), False),
    "empty-rows": lambda: (_empty_rows_layout(), False),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_k9_plain_matches_pallas(case):
    """o, lse and the q/k/v gradients (one cotangent) of the port's route
    on the CPU against the Pallas kernel's custom VJP."""
    layout, causal = K9_CASES[case]()
    q, k, v, g = _qkvg(1, 2, 256, 64, seed=sorted(K9_CASES).index(case))
    fn = lambda a, b, c: jax_bsa_bhsd(a, b, c, layout, 16, causal=causal, block_mult=4)
    ref_o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(g))
    lay8 = np.ascontiguousarray(layout.astype(np.uint8))
    _, ref_lse = jax_get_bsa(lay8.tobytes(), lay8.shape, 16, causal, 4).fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64 ** -0.5)

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = k9.block_sparse_attention_bhsd(qt, kt, vt, layout, 16, causal=causal,
                                         block_mult=4)
    out.backward(_t(g))
    tables = k9.get_tables(layout, 16, causal, 256, "cpu")
    _, lse = k9.block_sparse_fwd_plain(_t(q), _t(k), _t(v), tables, 64 ** -0.5)
    _close(out.detach(), ref_o)
    _close(lse, np.asarray(ref_lse)[..., 0])
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref_grads):
        _close(got, want)
    if case in ("masked-fine-row", "empty-rows"):
        rows = slice(80, 96) if case == "masked-fine-row" else slice(128, 256)
        assert out.detach()[:, :, rows].abs().max() == 0
        assert qt.grad[:, :, rows].abs().max() == 0
        assert (lse[:, :, rows] == k9.NEG_INF).all()


def test_k9_bthd_entry_matches_pallas():
    """The [B, T, H, D] entry (two batch rows, D = 32) against JAX's."""
    from deepspeed_tpu.ops.pallas.block_sparse_attention import block_sparse_attention as jax_bsa
    layout = tsa.BigBirdSparsityConfig(num_heads=2).make_layout(256)
    rng = np.random.RandomState(9)
    q, k, v = [(rng.randn(2, 256, 2, 32) * 0.5).astype(np.float32) for _ in range(3)]
    ref = jax_bsa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layout, 16, block_mult=4)
    _close(block_sparse_attention(_t(q), _t(k), _t(v), layout, 16), ref)


# --------------------------------------------------------------------------- #
# (c) the op's entry point against JAX's (dense route there on the CPU)
# --------------------------------------------------------------------------- #

OP_CASES = {
    "fixed-uni": lambda: tsa.FixedSparsityConfig(num_heads=2, attention="unidirectional"),
    "fixed-per-head": lambda: tsa.FixedSparsityConfig(
        num_heads=2, different_layout_per_head=True, num_different_global_patterns=2),
    "bigbird": lambda: tsa.BigBirdSparsityConfig(num_heads=2, seed=1),
}


def _jax_config(cfg):
    """The same config built by the JAX package (the attribute set is the
    constructor's)."""
    j = object.__new__(getattr(jsa, type(cfg).__name__))
    j.__dict__.update(cfg.__dict__)
    return j


@pytest.mark.parametrize("masks", ["none", "key_padding", "attn_mask", "both"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_sparse_self_attention_matches_jax(case, masks):
    cfg = OP_CASES[case]()
    B, H, S, D = 2, 2, 128, 32
    q, k, v, g = _qkvg(B, H, S, D, seed=len(case) + len(masks))
    rng = np.random.RandomState(4)
    kpm = (rng.rand(B, S) > 0.2).astype(np.int32) if masks in ("key_padding", "both") else None
    am = (rng.randn(1, H, S, S) * 0.3).astype(np.float32) if masks in ("attn_mask", "both") \
        else None
    opt = lambda a, conv: None if a is None else conv(a)
    fn = lambda a, b, c: jsa.sparse_self_attention(
        a, b, c, _jax_config(cfg), key_padding_mask=opt(kpm, jnp.asarray),
        attn_mask=opt(am, jnp.asarray))
    ref, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = tsa.sparse_self_attention(qt, kt, vt, cfg, key_padding_mask=opt(kpm, _t),
                                    attn_mask=opt(am, _t))
    out.backward(_t(g))
    _close(out.detach(), ref)
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref_grads):
        _close(got, want)


# --------------------------------------------------------------------------- #
# host tables, autograd, ragged shapes
# --------------------------------------------------------------------------- #

def _decode(tables, transposed):
    """The [Hl, S, S] pairs the tables admit (tile list x 16-bit masks x
    causal), as the kernels read them."""
    Hl, nt, S = tables.num_layout_heads, tables.num_tiles, tables.seq_len
    ptr = (tables.col_ptr if transposed else tables.row_ptr).numpy()
    ent = (tables.col_ent if transposed else tables.row_ent).numpy()
    m = np.zeros((Hl, nt * 4, nt * 4), bool)
    for h in range(Hl):
        for outer in range(nt):
            for inner, bits in ent[ptr[h, outer]:ptr[h, outer + 1]]:
                i, j = (inner, outer) if transposed else (outer, inner)
                for bit in range(16):
                    m[h, 4 * i + bit // 4, 4 * j + bit % 4] |= bool(bits >> bit & 1)
    m = m.repeat(16, 1).repeat(16, 2)[:, :S, :S]
    return m & np.tril(np.ones((S, S), bool)) if tables.causal else m


TABLE_CASES = {
    "fixed-per-head-S1040": (lambda: tsa.FixedSparsityConfig(
        num_heads=4, different_layout_per_head=True, num_different_global_patterns=4), 1040),
    "fixed-uni-S1040": (lambda: tsa.FixedSparsityConfig(
        num_heads=4, attention="unidirectional"), 1040),
    "bigbird-block32-S1056": (lambda: tsa.BigBirdSparsityConfig(
        num_heads=3, block=32, different_layout_per_head=True), 1056),
    "bslongformer-block128": (lambda: tsa.BSLongformerSparsityConfig(
        num_heads=2, block=128), 1024),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_tables_decode_to_token_mask(case):
    make, S = TABLE_CASES[case]
    cfg = make()
    layout = cfg.make_layout(S)
    tables = k9.get_tables(layout, cfg.block, cfg.attention == "unidirectional", S, "cpu")
    want_heads = 1 if not cfg.different_layout_per_head else cfg.num_heads
    assert tables.num_layout_heads == want_heads
    mask = tables.token_mask("cpu").numpy()
    np.testing.assert_array_equal(
        mask, np.kron(tables.layout, np.ones((cfg.block,) * 2, np.uint8)).astype(bool)
        & (np.tril(np.ones((S, S), bool)) if tables.causal else True))
    np.testing.assert_array_equal(_decode(tables, False), mask)
    np.testing.assert_array_equal(_decode(tables, True), mask)


def test_tables_are_cached_and_refuse_bad_shapes():
    layout = tsa.FixedSparsityConfig(num_heads=2).make_layout(128)
    t = k9.get_tables(layout, 16, False, 128, "cpu")
    assert k9.get_tables(layout.copy(), 16, False, 128, torch.device("cpu")) is t
    assert k9.get_tables(layout, 16, True, 128, "cpu") is not t
    with pytest.raises(ValueError, match="multiple of 16"):
        k9.get_tables(np.ones((1, 16, 16)), 8, False, 128, "cpu")
    with pytest.raises(ValueError, match="does not tile"):
        k9.get_tables(layout, 16, False, 256, "cpu")


@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_autograd_gradcheck_f64(causal):
    """The autograd function's backward (plain versions on the CPU) is the
    derivative of its forward, in f64 at a tiny shape: S = 48 (a ragged
    64-tile), per-head layouts, one query block with no active key."""
    rng = np.random.RandomState(5)
    layout = np.array([[[1, 0, 0], [1, 1, 0], [0, 1, 1]],
                       [[0, 0, 0], [0, 1, 1], [1, 0, 1]]])
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 48, 4)).requires_grad_() for _ in range(3))
    fn = lambda a, b, c: k9.block_sparse_attention_bhsd(a, b, c, layout, 16, causal=causal)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def _dense_masked(q, k, v, mask, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


@pytest.mark.parametrize("make, S", [
    (lambda: tsa.FixedSparsityConfig(num_heads=2, different_layout_per_head=True,
                                     num_different_global_patterns=2), 1040),
    (lambda: tsa.FixedSparsityConfig(num_heads=2, block=32,
                                     attention="unidirectional"), 1056),
], ids=["S1040-block16", "S1056-block32-causal"])
def test_ragged_shapes_match_dense_masked(make, S):
    """S that no 64-tile divides, D = 128: the plain route's output and
    gradients against torch's softmax over the layout's token mask."""
    cfg = make()
    causal = cfg.attention == "unidirectional"
    q, k, v, g = (_t(a) for a in _qkvg(1, 2, S, 128, seed=S))
    layout = cfg.make_layout(S)
    mask = torch.from_numpy(np.kron(layout, np.ones((cfg.block,) * 2, np.int64)) > 0)
    if causal:
        mask &= torch.ones(S, S, dtype=torch.bool).tril()
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = _dense_masked(*ins, mask, 128 ** -0.5)
    ref.backward(g)
    got_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = tsa.sparse_self_attention(*got_ins, cfg)
    got.backward(g)
    _close(got.detach(), ref.detach())
    for a, b in zip(got_ins, ins):
        _close(a.grad, b.grad)
