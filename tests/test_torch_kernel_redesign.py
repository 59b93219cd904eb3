"""What the tensor-core redesigns of K9's backward and K8's ``qmm_mma``
rely on, checked on the CPU (the kernels themselves run only on the card,
where ``chip_smoke.py`` holds them against their plain versions).

- K9's per-warp 16-block skip: a numpy model of the kernels' rule (dq:
  warp w of a q-tile reads bits ``(bits >> 4w) & 0xF`` of each entry of
  ``row_ptr``/``row_ent`` and computes the 16-key chunks whose bit is set;
  dk/dv: the block of key chunk c of a k-tile takes the query bands r
  with bit ``4r + c`` of each entry of ``col_ptr``/``col_ent``; causal
  masks key > query only in chunks on the diagonal) decodes to exactly the
  pairs of
  ``tables.token_mask``, over random layouts (block 16 and 32, causal and
  not, S that 64 does not divide).
- ``quantized_matmul`` routes M <= 8 to ``qmm_gemv`` and larger M to
  ``qmm_mma`` with the same arguments as before, and refuses the shapes it
  refused.
- The sparse op's layout cache: a cached layout is byte-equal to a fresh
  ``make_layout``; configs that differ only in ``seed`` get their own
  entries; K9's tables are cached under the same key.
"""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.kernels import _loader

# the modules by full name: the package re-exports same-named functions
k9 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.block_sparse_attention")
k8 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.quantized_matmul")

T, F = k9.TILE, k9.FINE


def _chunk_pairs(mask, rows0, keys0, causal):
    """Mark the 16 x 16 chunk at (rows0, keys0) as the kernel computes it:
    every pair, or key <= query where the chunk sits on the diagonal."""
    S = mask.shape[0]
    assert rows0 + F <= S and keys0 + F <= S, "an active chunk crosses the edge of S"
    block = np.ones((F, F), bool)
    if causal and rows0 == keys0:
        block = np.tril(block)
    mask[rows0:rows0 + F, keys0:keys0 + F] |= block


def _dq_pairs(tables, hl):
    """[S, S] bool: the pairs the dq kernel's warps compute for layout head hl."""
    S, nt = tables.seq_len, tables.num_tiles
    ptr, ent = tables.row_ptr.numpy()[hl], tables.row_ent.numpy()
    mask = np.zeros((S, S), bool)
    for it in range(nt):
        for kt, bits in ent[ptr[it]:ptr[it + 1]]:
            for w in range(4):
                band = (int(bits) >> (4 * w)) & 0xF
                for c in range(4):
                    if (band >> c) & 1:
                        _chunk_pairs(mask, it * T + F * w, kt * T + F * c, tables.causal)
    return mask


def _dkv_pairs(tables, hl):
    """[S, S] bool (query, key): the pairs the dk/dv kernel's warps compute."""
    S, nt = tables.seq_len, tables.num_tiles
    ptr, ent = tables.col_ptr.numpy()[hl], tables.col_ent.numpy()
    mask = np.zeros((S, S), bool)
    for jt in range(nt):
        for c in range(4):              # the block's key chunk
            for qt, bits in ent[ptr[jt]:ptr[jt + 1]]:
                for r in range(4):      # query band
                    if (int(bits) >> (4 * r + c)) & 1:
                        _chunk_pairs(mask, qt * T + F * r, jt * T + F * c, tables.causal)
    return mask


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(block=st.sampled_from([16, 32]), nb=st.integers(1, 11), heads=st.integers(1, 3),
       causal=st.booleans(), density=st.floats(0.05, 1.0), seed=st.integers(0, 2 ** 31 - 1))
def test_k9_band_bits_decode_to_token_mask(block, nb, heads, causal, density, seed):
    rng = np.random.default_rng(seed)
    layout = (rng.random((heads, nb, nb)) < density).astype(np.uint8)
    S = nb * block
    tables = k9.get_tables(layout, block, causal, S, "cpu")
    want = tables.token_mask("cpu").numpy()
    for hl in range(tables.num_layout_heads):
        np.testing.assert_array_equal(_dq_pairs(tables, hl), want[hl])
        np.testing.assert_array_equal(_dkv_pairs(tables, hl), want[hl])


@pytest.fixture
def launches(monkeypatch):
    """The K8 wrapper's CUDA route on CPU tensors: launches are recorded,
    not made."""
    calls = []
    monkeypatch.setattr(_loader, "on_cpu", lambda *a: False)
    monkeypatch.setattr(_loader, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_loader, "launch",
                        lambda name, entry, device, *args: calls.append((name, entry, args)))
    return calls


@pytest.mark.parametrize("M", [1, 8, 9, 63, 130, 736])
def test_quantized_matmul_routes_by_m(launches, M):
    K, N = 96, 48
    a = torch.zeros(M, K, dtype=torch.bfloat16)
    w8 = torch.zeros(K, N, dtype=torch.int8)
    out = k8.quantized_matmul(a, w8, torch.ones(1, N))
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    (name, entry, args), = launches
    if M <= k8.GEMV_MAX_M:
        rows, n_splits = k8.gemv_splits(K, N)
        assert (name, entry) == (k8.GEMV, "dstorch_qmm_gemv")
        assert args[6:] == (M, K, N, rows, n_splits)
    else:
        assert (name, entry) == (k8.MMA, "dstorch_qmm_mma")
        assert args[4:] == (M, K, N)


@pytest.mark.parametrize("a_shape, w_shape, w_dtype, n_scale", [
    ((4, 96), (64, 48), torch.int8, 48),      # a's K is not w8's
    ((4, 64), (64, 48), torch.int8, 40),      # a scale per column, not 40
    ((4, 64), (64, 48), torch.float32, 48),   # the weight is not int8
])
def test_quantized_matmul_refuses_bad_shapes(launches, a_shape, w_shape, w_dtype, n_scale):
    with pytest.raises(ValueError):
        k8.quantized_matmul(torch.zeros(a_shape, dtype=torch.bfloat16),
                            torch.zeros(w_shape, dtype=w_dtype), torch.ones(n_scale))
    assert not launches


def test_layout_cache_is_byte_equal_and_keyed_by_seed():
    S = 512
    a = tsa.BigBirdSparsityConfig(num_heads=4, block=16, different_layout_per_head=True,
                                  seed=1)
    b = tsa.BigBirdSparsityConfig(num_heads=4, block=16, different_layout_per_head=True,
                                  seed=2)
    la, lb = tsa.cached_layout(a, S), tsa.cached_layout(b, S)
    assert la.tobytes() == a.make_layout(S).tobytes()
    assert lb.tobytes() == b.make_layout(S).tobytes()
    assert la.tobytes() != lb.tobytes()
    # an equal config built anew hits the entry; another S or block does not
    again = tsa.BigBirdSparsityConfig(num_heads=4, block=16, different_layout_per_head=True,
                                      seed=1)
    assert tsa.cached_layout(again, S) is la
    assert tsa.cached_layout(a, 2 * S).shape == (4, 64, 64)
    c = tsa.BigBirdSparsityConfig(num_heads=4, block=32, different_layout_per_head=True,
                                  seed=1)
    assert tsa.cached_layout(c, S).shape == (4, 16, 16)
    assert not la.flags.writeable
    # the op's tables come from the same key: built once, from that layout
    tables = tsa._cached_tables(a, S, False, "cpu")
    assert tsa._cached_tables(again, S, False, "cpu") is tables
    assert tables.layout.tobytes() == la.astype(np.uint8).tobytes()
    assert tsa._cached_tables(a, S, True, "cpu") is not tables
