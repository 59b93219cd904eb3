"""What the tensor-core redesigns of K9 (forward and backward), K10's
backward and K8's ``qmm_mma`` rely on, checked on the CPU (the kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
their plain versions).

- K9's per-warp 16-block skip: a numpy model of the kernels' rule (dq:
  warp w of a q-tile reads bits ``(bits >> 4w) & 0xF`` of each entry of
  ``row_ptr``/``row_ent`` and computes the 16-key chunks whose bit is set;
  dk/dv: the block of key chunk c of a k-tile takes the query bands r
  with bit ``4r + c`` of each entry of ``col_ptr``/``col_ent``; causal
  masks key > query only in chunks on the diagonal) decodes to exactly the
  pairs of
  ``tables.token_mask``, over random layouts (block 16 and 32, causal and
  not, S that 64 does not divide).
- K9's forward walks the dq kernel's list with the same per-warp rule and
  copies only the 16-key chunks some band of an entry uses: every chunk a
  warp computes was copied, and every pair of ``tables.token_mask`` is
  computed exactly once.
- K10's d(pair) chunks (``dbias_chunks``) cover a group's rows once, in
  order, and fill the grid; the K9 and K10 wrappers count one launch per
  call under their names, d(pair) with its chunks and f32 scratch.
- ``quantized_matmul`` routes M <= 8 to ``qmm_gemv`` and larger M to
  ``qmm_mma`` with the same arguments as before, and refuses the shapes it
  refused; the engine's ``_mm`` sends a packed int4 weight at M <= 8 to
  ``qmm_gemv``'s int4 entry (the packed bytes read in the kernel) and at
  larger M to unpack + ``qmm_mma``; ``quantized_matmul_int4`` refuses odd
  K, a weight that is not int8, and a K/2 or N that does not match.
- The gemv split plan (``gemv_splits``) and the kernel's walk over it
  (warp w of a split takes 16-row steps w, w + 8, ...; lane quad t reads
  rows 2t, 2t + 1, 2t + 8, 2t + 9 of a step, or packed int4 rows t and
  t + 4) read every k exactly once, in one wave of blocks.
- The sparse op's layout cache: a cached layout is byte-equal to a fresh
  ``make_layout``; configs that differ only in ``seed`` get their own
  entries; K9's tables are cached under the same key.
"""

import contextlib
import importlib
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.kernels import _loader

from tests._torch_threads import one_torch_thread  # noqa: F401

# the modules by full name: the package re-exports same-named functions
k9 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.block_sparse_attention")
k8 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.quantized_matmul")
k10 = importlib.import_module("deepspeed_tpu_torch.ops.kernels.evoformer_attention")

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


def _fwd_counts(tables, hl):
    """[S, S] int: how often the forward kernel's warps compute each pair
    for layout head hl (warp w of a q-tile takes the chunks c with bit 4w +
    c of each entry); asserts that each was among the entry's copied
    chunks (the union of its four bands' bits)."""
    S, nt = tables.seq_len, tables.num_tiles
    ptr, ent = tables.row_ptr.numpy()[hl], tables.row_ent.numpy()
    counts = np.zeros((S, S), np.int64)
    for it in range(nt):
        for kt, bits in ent[ptr[it]:ptr[it + 1]]:
            bits = int(bits)
            copied = (bits | bits >> 4 | bits >> 8 | bits >> 12) & 0xF
            for w in range(4):
                band = (bits >> (4 * w)) & 0xF
                for c in range(4):
                    if (band >> c) & 1:
                        assert (copied >> c) & 1, "a computed chunk was not copied"
                        once = np.zeros((S, S), bool)
                        _chunk_pairs(once, it * T + F * w, kt * T + F * c, tables.causal)
                        counts += once
    return counts


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(block=st.sampled_from([16, 32]), nb=st.integers(1, 11), heads=st.integers(1, 3),
       causal=st.booleans(), density=st.floats(0.05, 1.0), seed=st.integers(0, 2 ** 31 - 1))
def test_k9_forward_computes_each_pair_once(block, nb, heads, causal, density, seed):
    rng = np.random.default_rng(seed)
    layout = (rng.random((heads, nb, nb)) < density).astype(np.uint8)
    S = nb * block
    tables = k9.get_tables(layout, block, causal, S, "cpu")
    want = tables.token_mask("cpu").numpy().astype(np.int64)
    for hl in range(tables.num_layout_heads):
        np.testing.assert_array_equal(_fwd_counts(tables, hl), want[hl])


@pytest.mark.parametrize("S, H, G, R", [(384, 8, 1, 512), (384, 4, 1, 384), (300, 4, 2, 4),
                                        (40, 2, 1, 6), (64, 1, 1, 1), (1000, 16, 4, 2)])
def test_dbias_chunks_cover_the_rows_and_fill_the_grid(S, H, G, R):
    C = k10.dbias_chunks(S, H, G, R)
    nt = -(-S // 64)
    blocks = nt * nt * G * H
    assert 1 <= C <= R
    # the fewest chunks that reach the target grid, or one a row
    assert C == R or blocks * C >= k10.DBIAS_BLOCKS
    assert C == 1 or blocks * (C - 1) < k10.DBIAS_BLOCKS
    rows = [r for c in range(C) for r in range(R * c // C, R * (c + 1) // C)]
    assert rows == list(range(R))
    if (S, H, G, R) == (384, 8, 1, 512):   # AlphaFold 2's MSA row attention
        assert C == 8


@pytest.fixture
def fake_library(monkeypatch):
    """The wrappers' CUDA route on CPU tensors through the real
    ``_loader.launch`` (which counts the launch): a stand-in library records
    each C call and returns 0."""
    calls = []

    class Library:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(_loader, "load_library", Library)
    monkeypatch.setattr(_loader, "on_cpu", lambda *a: False)
    monkeypatch.setattr(_loader, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("R", [1, 2])
def test_k9_k10_wrappers_count_one_launch_per_call(fake_library, R):
    L, S, H, D = 2 * R, 80, 2, 32
    bf = torch.bfloat16
    q, k, v, do = (torch.zeros(L, S, H, D, dtype=bf) for _ in range(4))
    pair, mask = torch.zeros(L // R, H, S, S, dtype=bf), torch.zeros(L, S)
    lse, delta = torch.zeros(L, H, S), torch.zeros(L, H, S)
    tables = k9.get_tables(np.ones((1, 5, 5), np.uint8), 16, False, S, "cpu")
    qb = torch.zeros(1, H, S, D, dtype=bf)
    names = (k10.FWD, k10.DQ, k10.DKV, k10.DBIAS, k9.FWD)
    before = {n: _loader.LAUNCHES[n] for n in names}
    k10.evoformer_fwd(q, k, v, mask, pair, 0.125, R)
    args = (q, k, v, mask, pair, do, lse, delta, 0.125, R)
    k10.evoformer_dq(*args)
    k10.evoformer_dkv(*args)
    dpair = k10.evoformer_dbias(*args)
    k9.block_sparse_fwd(qb, qb, qb, tables, 0.125)
    assert {n: _loader.LAUNCHES[n] - before[n] for n in names} == {n: 1 for n in names}
    assert [entry for entry, _ in fake_library] == [
        "dstorch_evoformer_fwd_bf16", "dstorch_evoformer_dq_bf16", "dstorch_evoformer_dkv_bf16",
        "dstorch_evoformer_dbias_bf16", "dstorch_block_sparse_fwd_bf16"]
    # d(pair): dpair, then the f32 scratch of C partials, L, S, H, D, R and C
    dbias_args = fake_library[3][1]
    C = k10.dbias_chunks(S, H, L // R, R)
    assert C == R and dbias_args[10:16] == (L, S, H, D, R, C)
    assert dbias_args[8].value == dpair.data_ptr() and dpair.shape == pair.shape
    assert dbias_args[9] is not None


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


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64])
def test_mm_routes_packed_int4_by_m(fake_library, M):
    from deepspeed_tpu_torch.inference.v2.ragged_model import _mm, quantize_weight_int4
    K, N = 96, 48
    qd = quantize_weight_int4(torch.randn(K, N, generator=torch.Generator().manual_seed(M)))
    a = torch.zeros(M, K, dtype=torch.bfloat16)
    names = (k8.GEMV, k8.GEMV_INT4, k8.MMA)
    before = {n: _loader.LAUNCHES[n] for n in names}
    out = _mm(a, qd)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    fused = M <= k8.GEMV_MAX_M
    assert {n: _loader.LAUNCHES[n] - before[n] for n in names} == {
        k8.GEMV: 0, k8.GEMV_INT4: int(fused), k8.MMA: int(not fused)}
    (entry, args), = fake_library
    if fused:
        rows, n_splits = k8.gemv_splits(K, N)
        assert entry == "dstorch_qmm_gemv_int4"
        assert args[1].value == qd["w4"].data_ptr() and args[6:11] == (M, K, N, rows, n_splits)
    else:
        assert entry == "dstorch_qmm_mma" and args[4:7] == (M, K, N)


@pytest.mark.parametrize("K, w_shape, w_dtype, n_scale", [
    (95, (47, 48), torch.int8, 48),       # an odd K
    (96, (48, 48), torch.uint8, 48),      # the packed weight is not int8
    (96, (96, 48), torch.int8, 48),       # K/2 rows expected, K given
    (96, (48, 48), torch.int8, 40),       # a scale per column, not 40
])
def test_quantized_matmul_int4_refuses_bad_shapes(launches, K, w_shape, w_dtype, n_scale):
    with pytest.raises(ValueError):
        k8.quantized_matmul_int4(torch.zeros(4, K, dtype=torch.bfloat16),
                                 torch.zeros(w_shape, dtype=w_dtype), torch.ones(n_scale))
    assert not launches


def _gemv_reads(K, rows, n_splits, int4):
    """How often the gemv kernel's lanes read each k (numpy model of its
    walk: split s covers [s * rows, min(K, (s + 1) * rows)); warp w takes
    16-row steps w, w + 8, ...; lane quad t reads rows 2t, 2t + 1, 2t + 8,
    2t + 9, or packed rows t and t + 4, each of whose bytes holds rows 2p
    and 2p + 1; rows at or past the split's end are not read)."""
    counts = np.zeros(K, np.int64)
    for sp in range(n_splits):
        k_lo, k_hi = sp * rows, min(K, (sp + 1) * rows)
        n_steps = -(-(k_hi - k_lo) // 16)
        for w in range(8):
            for step in range(w, n_steps, 8):
                k0 = k_lo + 16 * step
                for t in range(4):
                    if int4:
                        ks = [2 * p + e for p in (k0 // 2 + t, k0 // 2 + t + 4) for e in (0, 1)
                              if 2 * p < k_hi]
                    else:
                        ks = [k for k in (k0 + 2 * t, k0 + 2 * t + 1, k0 + 2 * t + 8,
                                          k0 + 2 * t + 9) if k < k_hi]
                    counts[ks] += 1
    return counts


@settings(max_examples=40, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(K2=st.integers(1, 4096), n16=st.integers(1, 64), M=st.integers(1, 8),
       sms=st.sampled_from([132, 114, 78, 1]), int4=st.booleans())
def test_gemv_split_plan_reads_every_k_once(launches, monkeypatch, K2, n16, M, sms, int4):
    K, N = 2 * K2, 16 * n16
    rows, n_splits = k8.gemv_splits(K, N, sms)
    assert rows % 128 == 0 and n_splits >= 1 and (n_splits - 1) * rows < K <= n_splits * rows
    col_blocks = -(-N // 128)
    assert col_blocks * n_splits <= max(2 * sms, col_blocks)     # one wave
    np.testing.assert_array_equal(_gemv_reads(K, rows, n_splits, int4), np.ones(K, np.int64))
    # the wrappers launch that plan, with split-K scratch for M rows
    monkeypatch.setattr(_loader, "sm_count", lambda device: sms)
    a = torch.zeros(M, K, dtype=torch.bfloat16)
    if int4:
        k8.quantized_matmul_int4(a, torch.zeros(K // 2, N, dtype=torch.int8), torch.ones(N))
    else:
        k8.quantized_matmul(a, torch.zeros(K, N, dtype=torch.int8), torch.ones(N))
    (name, entry, args), = launches
    assert name == (k8.GEMV_INT4 if int4 else k8.GEMV)
    assert args[6:] == (M, K, N, rows, n_splits)
    launches.clear()


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
