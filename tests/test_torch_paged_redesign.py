"""What the redesigned paged decode kernel (K3/K4/K6, a thread-block
cluster per (sequence, kv head)) and K7's partials kernel rely on, checked
on the CPU (the kernels themselves run only on the card, where
``chip_smoke.py`` holds them against their plain versions).

- The cut: a numpy model of the kernels' ``decode_piece`` (piece p of n of
  [lo, hi) is ``[lo + p c, min(lo + (p + 1) c, hi))``, c = ceil((hi - lo) /
  n)) equals ``paged_splitk.piece_bounds`` and covers each sequence's
  visible range exactly once, in order (windows, side rows at j = 0/7/15,
  ``lens = 0``, ranges shorter than n), reads through ring tables only
  pages inside the visible range, and never needs more block-table entries
  than the block stages (``decode_table_cap``, from shapes only).
- The decode kernel's cluster: ``cluster_ranks`` depends on S, Hkv and the
  SM count only; its ranks' slices cover the visible range once.
- Through a stand-in library, both wrappers launch their C entries with
  the arguments of every branch (bf16 and int8 pages, window, ALiBi, side
  rows at C = 1 and C > 1, 2/4/8 splits) and count one launch under the
  names they had.
- The plain K7, now cut per sequence, against the JAX package's Pallas K7
  in interpret mode at a tiny shape: window, int8 pages, ALiBi and the side
  piece, at 2, 3 and 8 splits (pieces of one token and empty pieces).
  Tolerance 1e-5 relative plus 1e-5 absolute in f32 (the two cut the range
  differently and sum the same f32 products in other orders).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import paged_attention as pa
from deepspeed_tpu.ops.pallas import paged_splitk as jsk
from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels import paged_decode as pd
from deepspeed_tpu_torch.ops.kernels import paged_splitk as psk
from deepspeed_tpu_torch.ops.kernels.kv_quant import scale_tile_rows

from tests._torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# numpy model of the kernels' cut
# --------------------------------------------------------------------- #

def _visible(length, side, j, window):
    """decode_visible: the first visible page token and side row."""
    if not window:
        return 0, 0
    return max((length + j + 1 if side else length) - window, 0), max(j + 1 - window, 0)


def _piece(lo, hi, n, p):
    """decode_piece: piece p of n of [lo, hi)."""
    length = max(hi - lo, 0)
    c = -(-length // n)
    b_lo = min(lo + p * c, lo + length)
    return b_lo, min(b_lo + c, lo + length)


def _table_cap(MB, tokens, bs):
    """decode_table_cap: block-table entries a block stages."""
    return min(MB, tokens // bs + 2)


def _ring_table(MB, ring):
    """A block-table row whose logical page i >= ring repeats page i - ring."""
    return np.array([100 + (i % ring) for i in range(MB)], np.int64)


CUT_CASES = [
    # (lens, side, j, window, n)
    ([12032, 5032, 2032, 332], False, 0, 4096, 4),    # Mistral's phase 3 rows
    ([4264, 2000, 900, 200], False, 0, None, 8),      # 13B: short rows, 8 splits
    ([905, 305, 125, 45], True, 0, None, 2),          # side rows, j = 0
    ([905, 305, 125, 45], True, 7, 8, 4),             # j = 7 under a window of 8
    ([905, 305, 125, 45], True, 15, 8, 4),            # j >= window: pages unseen
    ([0, 1, 3, 7], False, 0, None, 8),                # lens 0, ranges shorter than n
    ([300, 65, 1, 0], False, 0, 37, 3),               # window start mid-page
    ([0, 0], True, 15, 200, 2),                       # nothing visible at all
]


@pytest.mark.parametrize("lens, side, j, window, n", CUT_CASES)
def test_pieces_cover_the_visible_range_once_in_order(lens, side, j, window, n):
    lo_t, hi_t = psk.piece_bounds(torch.tensor(lens, dtype=torch.int32), j, window, side, n)
    for s, length in enumerate(lens):
        lo, _ = _visible(length, side, j, window)
        pieces = [_piece(lo, length, n, p) for p in range(n)]
        assert pieces == list(zip(lo_t[s].tolist(), hi_t[s].tolist()))
        covered = [t for b_lo, b_hi in pieces for t in range(b_lo, b_hi)]
        assert covered == list(range(lo, length))       # once each, in order
        sizes = [b_hi - b_lo for b_lo, b_hi in pieces]
        assert max(sizes) == -(-max(length - lo, 0) // n)     # no piece holds more


@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("lens, side, j, window, n", CUT_CASES)
def test_pieces_stage_few_enough_table_entries(bs, lens, side, j, window, n):
    """Each block's pages fit the table slice it stages: K7 sizes it from
    split_tokens = ceil(MB / n) * bs, the decode kernel from ceil(MB bs /
    n_cl); a ring table (logical page i >= ring repeats i - ring) is read
    only at visible tokens, which land on distinct (page, slot) pairs."""
    MB = max(1, -(-max(lens) // bs) + 1)
    caps = {"splitk": _table_cap(MB, psk.split_pages(MB, n) * bs, bs),
            "decode": _table_cap(MB, -(-MB * bs // n), bs)}
    ring = max(1, -(-(window or 0) // bs) + 1) if window else MB
    for length in lens:
        lo, _ = _visible(length, side, j, window)
        row = _ring_table(MB, ring)
        seen = set()
        for p in range(n):
            b_lo, b_hi = _piece(lo, length, n, p)
            if b_hi <= b_lo:
                continue
            n_pages = (b_hi - 1) // bs - b_lo // bs + 1
            assert n_pages <= min(caps.values())
            for t in range(b_lo, b_hi):
                seen.add((row[t // bs], t % bs))
        assert len(seen) == max(length - lo, 0)


@pytest.mark.parametrize("S, Hkv", [(4, 8), (4, 32), (4, 40), (32, 32), (1, 1), (4, 16),
                                    (8, 2)])
@pytest.mark.parametrize("sms", [132, 114, 78, 1])
@pytest.mark.parametrize("quant", [False, True])
def test_cluster_ranks_come_from_shapes_and_sms(S, Hkv, sms, quant):
    n = pd.cluster_ranks(S, Hkv, sms, quant)
    most = pd.CLUSTER_MAX[quant]
    assert n in (1, 2, 4, 8) and n <= most
    # the smallest power of two that gives a block an SM (two over int8
    # pages), at most 4 (8 over int8 pages)
    want = (2 if quant else 1) * sms
    assert n == most or S * Hkv * n >= want
    assert n == 1 or S * Hkv * (n // 2) < want


def test_cluster_ranks_at_the_main_paths():
    """The cluster sizes phase 3 prints on the H100 (132 SMs)."""
    assert [pd.cluster_ranks(4, Hkv, 132, quant) for Hkv, quant in (
        (8, False), (32, False), (40, False), (40, True), (8, True), (16, False),
        (32, True))] == [4, 2, 1, 2, 8, 4, 4]


@pytest.mark.parametrize("side", [False, True])
def test_cluster_slices_cover_the_visible_range(side):
    """The decode kernel's ranks cut the visible range (whose start moves
    with j when side rows follow the pages) as K7's pieces do."""
    for lens, window, j in (([12032, 5032, 2032, 332], 4096, 0), ([2048, 0, 7, 1], None, 0),
                            ([905, 305, 125, 45], 8, 15)):
        n_cl = pd.cluster_ranks(len(lens), 8, 132)
        for length in lens:
            lo, _ = _visible(length, side, j, window)
            slices = [_piece(lo, length, n_cl, r) for r in range(n_cl)]
            assert [t for a, b in slices for t in range(a, b)] == list(range(lo, length))


# --------------------------------------------------------------------- #
# the wrappers' launches through a stand-in library
# --------------------------------------------------------------------- #

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
    monkeypatch.setattr(_loader, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls


BRANCHES = [(quant, window, alibi, C) for quant in (False, True)
            for window, alibi in ((None, False), (200, False), (None, True))
            for C in (0, 1, 16)]


def _inputs(quant, C, S=4, H=32, Hkv=8, D=128, bs=128, MB=36):
    pool = torch.zeros(6, 2, Hkv, bs, D, dtype=torch.int8 if quant else torch.bfloat16)
    tiles = torch.zeros(6, scale_tile_rows(Hkv, bs), 128) if quant else None
    side_dt = torch.float32 if quant else torch.bfloat16
    side = (torch.zeros(S, C * Hkv, D, dtype=side_dt),) * 2 if C else ()
    return (torch.zeros(S, H, D, dtype=torch.bfloat16), pool,
            torch.zeros(S, MB, dtype=torch.int32), torch.full((S,), 300, dtype=torch.int32),
            side, tiles)


@pytest.mark.parametrize("quant, window, alibi, C", BRANCHES)
def test_decode_wrapper_launches_each_branch(fake_library, quant, window, alibi, C):
    q, pool, bt, lens, side, tiles = _inputs(quant, C)
    S, H, D = q.shape
    Hkv, bs, MB = pool.shape[2], pool.shape[3], bt.shape[1]
    name = pd.launch_name(quant, window, alibi, C)
    before = _loader.LAUNCHES.get(name, 0)
    j = C - 1 if C else 0
    out = pd.paged_decode_attention(q, pool, bt, lens, *side, j=j, kv_scales=tiles,
                                    window=window, alibi=alibi)
    assert out.shape == q.shape and _loader.LAUNCHES[name] == before + 1
    (entry, args), = fake_library
    shape = (S, H, Hkv, D, bs, MB) + ((tiles.shape[1],) if quant else ()) + (
        C, j, window or 0, D ** -0.5, pd.cluster_ranks(S, Hkv, 132, quant), 0)   # 0: stream
    if quant:
        assert entry == "dstorch_paged_decode_int8" and args[9:] == shape
        assert args[2].value == tiles.data_ptr()
    else:
        assert entry == "dstorch_paged_decode_bf16" and args[8:] == shape
    assert (args[5 if quant else 4] is not None) == bool(C)
    assert (args[7 if quant else 6] is not None) == alibi
    assert name.startswith("paged_decode_int8" if quant else "paged_decode")
    assert ("_side" in name) == (C > 1)
    assert ("_window" in name) == (window is not None) and ("_alibi" in name) == alibi


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("quant, window, alibi, C", BRANCHES)
def test_splitk_wrapper_launches_each_branch(fake_library, quant, window, alibi, C, n):
    q, pool, bt, lens, side, tiles = _inputs(quant, C)
    S, H, D = q.shape
    Hkv, bs, MB = pool.shape[2], pool.shape[3], bt.shape[1]
    name = psk.kernel_name(n, window, alibi, side=C > 1, quant=quant)
    names = (name, psk.MERGE)
    before = {k: _loader.LAUNCHES.get(k, 0) for k in names}
    j = C - 1 if C else 0
    out = psk.splitk_attention(q, pool, bt, lens, n, *side, j=j, kv_scales=tiles,
                               window=window, alibi=alibi)
    assert out.shape == q.shape
    assert {k: _loader.LAUNCHES[k] - before[k] for k in names} == {name: 1, psk.MERGE: 1}
    (entry, args), (merge, margs) = fake_library
    P = n + (1 if C else 0)
    shape = (S, H, Hkv, D, bs, MB) + ((tiles.shape[1],) if quant else ()) + (
        C, j, n, psk.split_pages(MB, n) * bs, window or 0, D ** -0.5, 0)
    if quant:
        assert entry == "dstorch_paged_splitk_int8" and args[10:] == shape
    else:
        assert entry == "dstorch_paged_splitk_bf16" and args[9:] == shape
    assert (args[7 if quant else 6] is not None) == alibi
    assert merge == "dstorch_splitk_merge" and margs[4:8] == (S, P, H, D)


# --------------------------------------------------------------------- #
# the plain K7, cut per sequence, against the Pallas K7 (interpret mode)
# --------------------------------------------------------------------- #

S, H, HKV, D, BS, NB, MB = 4, 4, 2, 128, 64, 24, 6
MODES = {"none": {}, "window": {"window": 37}, "alibi": {"alibi": True}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **F32)


def _jit(fn, *static, **kw):
    return jax.jit(lambda *a, kv_scales: fn(*a, *static, kv_scales=kv_scales, **kw))


def _tables(rng, ctxs, mode):
    """Under the window each row owns 3 physical pages and logical page
    i >= 3 repeats page i - 3 (the page ring)."""
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    ring = 3 if mode == "window" else MB
    for i, c in enumerate(ctxs):
        own = perm[i * ring:(i + 1) * ring]
        for p in range(-(-c // BS)):
            bt[i, p] = own[p % ring]
    return bt


def _pool(rng, quant):
    kv = (rng.randn(NB, 2, HKV, BS, D) * rng.uniform(0.1, 3, (NB, 2, HKV, BS, 1))
          ).astype(np.float32)
    if not quant:
        return jnp.asarray(kv), None, _t(kv), None
    kvq, scl = pa.kv_quantize_rows(jnp.asarray(kv))
    tiles = pa.kv_scales_to_tiles(scl)
    return kvq, tiles, _t(kvq), _t(tiles)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_k7_matches_pallas_k7(mode, quant, n):
    """Pages only, with the merged lse: an empty row, one token (pieces of
    0 and 1 token), a window start mid-page through the ring, ALiBi."""
    rng = np.random.RandomState(11 + n)
    jpool, jtiles, pool, tiles = _pool(rng, quant)
    ctx = np.array([0, 1, 65, 300], np.int32)
    bt = _tables(rng, ctx, mode)
    q = rng.randn(S, H, D).astype(np.float32)
    ref, ref_lse = _jit(jsk.paged_decode_attention_splitk_pallas, n, with_lse=True,
                        **MODES[mode])(jnp.asarray(q), jpool, jnp.asarray(bt),
                                       jnp.asarray(ctx), kv_scales=jtiles)
    out, lse = psk.splitk_attention_plain(_t(q), pool, _t(bt), _t(ctx), n, kv_scales=tiles,
                                          with_lse=True, **MODES[mode])
    _close(out, ref)
    _close(lse.numpy()[ctx > 0], np.asarray(ref_lse)[ctx > 0])
    assert float(out[0].abs().max()) == 0.0 and float(lse[0].max()) <= 0.5 * psk.NEG_INF


@pytest.mark.parametrize("j", [0, 3])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_k7_side_piece_matches_pallas(mode, quant, j):
    """The side-buffer dispatcher: 3 splits of each prefix plus the side
    piece (C = 4 rows, f32 ``kv_write_dequant`` rows over int8 pages)."""
    rng = np.random.RandomState(21 + j)
    jpool, jtiles, pool, tiles = _pool(rng, quant)
    C = 4
    pfx = np.array([0, 1, 130, 280], np.int32)
    bt = _tables(rng, pfx + C, mode)
    q = rng.randn(S, H, D).astype(np.float32)
    sk, sv = (rng.randn(S, C, HKV, D).astype(np.float32) for _ in range(2))
    if quant:
        sk, sv = (np.asarray(pa.kv_write_dequant(jnp.asarray(x))) for x in (sk, sv))
    ref = _jit(jsk.paged_sidebuf_attention_splitk, j, n_splits=3, **MODES[mode])(
        jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(pfx), jnp.asarray(sk),
        jnp.asarray(sv), kv_scales=jtiles)
    got = psk.splitk_attention_plain(_t(q), pool, _t(bt), _t(pfx), 3,
                                     _t(sk).reshape(S, C * HKV, D),
                                     _t(sv).reshape(S, C * HKV, D), j, kv_scales=tiles,
                                     **MODES[mode])
    _close(got, ref)
