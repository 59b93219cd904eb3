"""What the redesigned paged chunk kernel (K5, a block of 64 (row, head)
pairs a (q-tile, kv head, slot) on the tensor cores) and the engine's
chunk routing rely on, checked on the CPU (the kernel itself runs only on
the card, where ``chip_smoke.py`` holds it against its plain version).

- The launch plan from shapes: ``chunk_grid`` covers every (row, head)
  pair of a slot once; a numpy model of the kernel's walk (each block's key
  range [k_lo, k_hi), its tiles of 64 keys (16 at D = 256), each warp's
  skipped tiles and edge tiles) computes every visible (row, key) pair,
  masks only in edge tiles, reads no page below a block's first row's
  window start, and never needs more block-table entries than
  ``chunk_table_cap`` stages.
- Through a stand-in library, the wrapper launches its C entry with the
  arguments of each of the six branches (bf16 and int8 pages, with no
  window, a window and ALiBi) and counts one launch under their names.
- The plain K5 against the JAX package's Pallas K5 in interpret mode at
  the edges the kernel walks: rows straddling pages at bs 16 and 64, a
  slot whose rows run past its context, an empty slot, a window over ring
  tables, G = 4 and D = 80, in f32 (2e-5 absolute, as the other K5 tests).
- ``AttentionKernelSpec.chunk`` at split rungs 2, 4 and 8 (now the chunk
  kernel at every rung) against the JAX package's
  ``paged_chunk_attention_splitk`` (its split path there): windowed, ALiBi
  and over int8 pages, 1e-5 relative plus 1e-5 absolute in f32 (the two
  sum the same f32 products in other orders).
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
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.ragged_model import RaggedModelSpec
from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels import paged_chunk as pc
from deepspeed_tpu_torch.ops.kernels.kv_quant import scale_tile_rows

from tests._torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
F32 = dict(rtol=1e-5, atol=1e-5)
WARPS, WARP_ROWS = 4, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jit(fn, **kw):
    return jax.jit(lambda *a: fn(*a, **kw))


# --------------------------------------------------------------------- #
# the launch plan and a numpy model of the kernel's walk
# --------------------------------------------------------------------- #

def _bk(D):
    """Keys a tile (the kernel's kChBK)."""
    return 16 if D > 128 else 64


def _block(Cs, G, q0, ctx, window, qt, BK):
    """One block's walk: its key range, its tiles' first keys, and for each
    warp (pairs, computed tiles, edge tiles)."""
    n_pairs, i0 = Cs * G, qt * pc.CHUNK_ROWS
    r_first, r_last = i0 // G, (min(i0 + pc.CHUNK_ROWS, n_pairs) - 1) // G
    k_lo = max(0, q0 + r_first - window + 1) if window else 0
    k_hi = min(ctx, q0 + r_last + 1)
    tiles = list(range(k_lo, k_hi, BK)) if k_hi > k_lo else []
    warps = []
    for w in range(WARPS):
        wi0 = i0 + WARP_ROWS * w
        pairs = range(wi0, min(wi0 + WARP_ROWS, n_pairs))
        if not pairs:
            warps.append((pairs, set(), set()))
            continue
        lo, hi = q0 + wi0 // G, q0 + (pairs[-1]) // G
        done = {k0 for k0 in tiles
                if k0 <= hi and not (window and k0 + BK - 1 <= lo - window)}
        edge = {k0 for k0 in done
                if k0 + BK - 1 > lo or k0 + BK > ctx or (window and k0 <= hi - window)}
        warps.append((pairs, done, edge))
    return k_lo, k_hi, tiles, warps


def _sees(q_pos, keys, ctx, window):
    """[rows, keys]: which keys each row position sees."""
    q, k = np.asarray(q_pos)[:, None], np.asarray(keys)[None]
    return (k <= q) & (k < ctx) & ((q - k < window) if window else True)


WALKS = [  # (Cs, G, D, bs, MB, q0s, ctxs, window)
    (128, 1, 128, 128, 16, [1920, 1408, 872, 172, 0, 0], [2048, 1536, 1000, 300, 128, 0], None),
    (128, 4, 128, 128, 128, [11904, 4904, 1904, 204], [12032, 5032, 2032, 332], 4096),
    (96, 4, 128, 16, 126, [1904, 737, 34, 0], [2000, 777, 130, 0], 200),
    (96, 71, 64, 64, 33, [1904, 737, 34, 0], [2000, 777, 130, 0], None),
    (96, 8, 256, 16, 126, [1904, 737, 34, 0], [2000, 777, 130, 0], 37),
    (40, 2, 80, 16, 10, [0, 11, 100], [40, 30, 140], 1),
]


@pytest.mark.parametrize("Cs, G, D, bs, MB, q0s, ctxs, window", WALKS)
def test_chunk_walk_computes_every_visible_pair(Cs, G, D, bs, MB, q0s, ctxs, window):
    """The model of the kernel's walk at each slot: every (row, head) pair
    is in exactly one block; a warp computes the tile of every key its rows
    see, every key of a computed tile that is not an edge tile is seen by
    all its rows, no key below the block's range is loaded (so pages wholly
    below it are never read), and the pages the range spans fit the staged
    table slice."""
    BK, Hkv = _bk(D), 2
    nq, hk, nc = pc.chunk_grid(len(ctxs), Cs, G * Hkv, Hkv)
    assert (hk, nc) == (Hkv, len(ctxs))
    assert (nq - 1) * pc.CHUNK_ROWS < Cs * G <= nq * pc.CHUNK_ROWS
    cap = pc.chunk_table_cap(MB, bs, window)
    for q0, ctx in zip(q0s, ctxs):
        covered = []
        for qt in range(nq):
            k_lo, k_hi, tiles, warps = _block(Cs, G, q0, ctx, window, qt, BK)
            if k_hi > k_lo:
                assert (k_hi - 1) // bs - k_lo // bs + 1 <= cap
            for pairs, done, edge in warps:
                covered += list(pairs)
                q_pos = q0 + np.asarray(pairs, int) // G
                seen = np.flatnonzero(_sees(q_pos, np.arange(ctx), ctx, window).any(0))
                assert ((seen >= k_lo) & (seen < k_hi)).all()
                assert set(k_lo + (seen - k_lo) // BK * BK) <= done
                for k0 in done - edge:
                    assert _sees(q_pos, np.arange(k0, k0 + BK), ctx, window).all()
        assert covered == list(range(Cs * G))


def test_chunk_table_cap_from_shapes():
    """Without a window a block may span the whole row; under one, at most
    window + 63 keys: the decode walk's cap, never above the row."""
    assert pc.chunk_table_cap(36, 128, None) == 36
    assert pc.chunk_table_cap(128, 128, 4096) == 34
    assert pc.chunk_table_cap(126, 16, 200) == 18
    assert pc.chunk_table_cap(4, 16, 4096) == 4


# --------------------------------------------------------------------- #
# the wrapper's launches through a stand-in library
# --------------------------------------------------------------------- #

@pytest.fixture
def fake_library(monkeypatch):
    """The wrapper's CUDA route on CPU tensors through the real
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


BRANCHES = [(quant, window, alibi) for quant in (False, True)
            for window, alibi in ((None, False), (200, False), (None, True))]


@pytest.mark.parametrize("quant, window, alibi", BRANCHES)
def test_chunk_wrapper_launches_each_branch(fake_library, quant, window, alibi):
    NC, Cs, H, Hkv, D, bs, MB = 3, 96, 32, 8, 128, 16, 20
    q = torch.zeros(NC, Cs, H, D, dtype=torch.bfloat16)
    pool = torch.zeros(5, 2, Hkv, bs, D, dtype=torch.int8 if quant else torch.bfloat16)
    tiles = torch.zeros(5, scale_tile_rows(Hkv, bs), 128) if quant else None
    bt = torch.zeros(NC, MB, dtype=torch.int32)
    q0, ctx = torch.zeros(NC, dtype=torch.int32), torch.full((NC,), 90, dtype=torch.int32)
    name = _loader.variant(pc.NAME_INT8 if quant else pc.NAME, window, alibi)
    before = _loader.LAUNCHES.get(name, 0)
    out = pc.paged_chunk_attention_batched(q, pool, bt, q0, ctx, kv_scales=tiles,
                                           window=window, alibi=alibi)
    assert out.shape == q.shape and _loader.LAUNCHES[name] == before + 1
    (entry, args), = fake_library
    shape = (NC, Cs, H, Hkv, D, bs, MB) + ((tiles.shape[1],) if quant else ()) + (
        window or 0, D ** -0.5, 0)   # 0: the stream
    if quant:
        assert entry == "dstorch_paged_chunk_int8" and args[8:] == shape
        assert args[2].value == tiles.data_ptr()
    else:
        assert entry == "dstorch_paged_chunk_bf16" and args[7:] == shape
    assert (args[6 if quant else 5] is not None) == alibi
    assert name == ("paged_chunk" + ("_int8" if quant else "") + ("_window" if window else "")
                    + ("_alibi" if alibi else ""))


# --------------------------------------------------------------------- #
# the plain K5 against the Pallas K5 (interpret mode) at the walk's edges
# --------------------------------------------------------------------- #

def _ring_tables(rng, ctxs, bs, MB, NB, ring):
    """Block tables as the page ring makes them: each row owns ``ring``
    physical pages and logical page i >= ring repeats page i - ring."""
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    for i, c in enumerate(ctxs):
        own = perm[i * ring:(i + 1) * ring]
        for p in range(-(-c // bs)):
            bt[i, p] = own[p % ring]
    return bt


EDGES = {  # (H, Hkv, D, bs, window, ring)
    "bs16 G=4": (8, 2, 64, 16, None, None),
    "bs64 G=1": (2, 2, 32, 64, None, None),
    "window ring bs16": (8, 2, 64, 16, 37, 6),
    "D=80 G=4 window": (8, 2, 80, 16, 21, 4),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_plain_chunk_matches_pallas_at_the_edges(case):
    """Slot 0's rows straddle pages (q_start 21), slot 1's run past its
    context (a pass's partly filled slot), slot 2 is empty."""
    H, Hkv, D, bs, window, ring = EDGES[case]
    rng = np.random.RandomState(len(case))
    Cs, ctxs, q0s = 24, [120, 47, 0], [21, 37, 0]
    MB = -(-max(ctxs) // bs) + 1
    NB = 3 * (ring or MB)
    pool = rng.randn(NB, 2, Hkv, bs, D).astype(np.float32)
    if ring:
        bt = _ring_tables(rng, ctxs, bs, MB, NB, ring)
    else:
        bt = rng.permutation(NB)[:3 * MB].reshape(3, MB).astype(np.int32)
    qc = rng.randn(3, Cs, H, D).astype(np.float32)
    q0, ctx = np.array(q0s, np.int32), np.array(ctxs, np.int32)
    ref = _jit(pa.paged_chunk_attention_batched, window=window)(
        jnp.asarray(qc), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(q0), jnp.asarray(ctx))
    got = pc.paged_chunk_attention_batched_plain(_t(qc), _t(pool), _t(bt), _t(q0), _t(ctx),
                                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert not got[2].any()


# --------------------------------------------------------------------- #
# the engine's chunk dispatch at every rung against JAX's split path
# --------------------------------------------------------------------- #

MODES = {"window": dict(window=21), "alibi": dict(alibi=True), "int8": dict(quant=True)}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunk_dispatch_at_every_rung_matches_jax(mode, n):
    kw = MODES[mode]
    H, Hkv, D, bs, NB, MB = 4, 2, 128, 64, 12, 4
    rng = np.random.RandomState(n + 3 * len(mode))
    spec = RaggedModelSpec(family="llama", num_layers=1, hidden_size=H * D, num_heads=H,
                           num_kv_heads=Hkv, head_dim=D, vocab_size=16,
                           window=kw.get("window"), alibi=kw.get("alibi", False))
    ak = AttentionKernelSpec(spec, n_splits=n)
    pool = rng.randn(NB, 2, Hkv, bs, D).astype(np.float32)
    bt = rng.permutation(NB)[:3 * MB].reshape(3, MB).astype(np.int32)
    Cs = 8
    qc = rng.randn(3, Cs, H, D).astype(np.float32)
    ctx = np.array([0, 70, 250], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    jax_pool, port_pool, jax_sc, port_sc = jnp.asarray(pool), _t(pool), None, None
    if kw.get("quant"):
        jax_pool, scl = pa.kv_quantize_rows(jnp.asarray(pool))
        jax_sc = pa.kv_scales_to_tiles(scl)
        port_pool, port_sc = _t(np.asarray(jax_pool)), _t(np.asarray(jax_sc))
    split = jax.jit(lambda q, p, b, s0, c, sc: jsk.paged_chunk_attention_splitk(
        q, p, b, s0, c, window=ak.window, alibi=ak.alibi, kv_scales=sc, n_splits=n))
    ref = split(jnp.asarray(qc), jax_pool, jnp.asarray(bt), jnp.asarray(q0),
                jnp.asarray(ctx), jax_sc)
    got = ak.chunk(_t(qc), port_pool, _t(bt), _t(q0), _t(ctx), kv_scales=port_sc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
