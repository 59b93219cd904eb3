"""The port's multi-tenant LoRA units (``inference/v2/lora/``,
``module_inject/lora.py``, ``runtime/swap_tensor/buffer_pool.py``,
``utils/fault_injection.py``) against the JAX package's.

Mirrors ``tests/unit/test_lora_serving.py`` (pool and registry units, the
mutating-thread reader test) and ``tests/unit/test_module_inject_lora.py``:
the pool's host round trip byte for byte, overcommit refused, LRU eviction
with a byte-exact restore, refcounts gating eviction and
``can_admit(releasing=)``, cancel-while-faulting rolled back through the
chaos site, every loader refusal in the JAX package's words, and the page
layout and packing equal to the JAX package's for an MHA spec and a GQA
spec (whose k/v blocks pad to ``out_max``).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.lora import LoraAdapterRegistry as JaxRegistry
from deepspeed_tpu.inference.v2.lora import LoraPagePool as JaxPool
from deepspeed_tpu.inference.v2.ragged_model import RaggedModelSpec as JaxSpec
from deepspeed_tpu.inference.v2.ragged_model import lora_page_layout as jax_layout
from deepspeed_tpu.module_inject.lora import load_lora_adapter as jax_load
from deepspeed_tpu.module_inject.lora import pack_lora_pages as jax_pack
from deepspeed_tpu.module_inject.lora import validate_lora_adapter as jax_validate
from deepspeed_tpu_torch.inference.v2.lora import (EVICTED, REGISTERED, RESIDENT,
                                                   LoraAdapterRegistry, LoraPagePool)
from deepspeed_tpu_torch.inference.v2.ragged_model import (LORA_TARGETS, RaggedModelSpec,
                                                           lora_page_layout, lora_target_dims)
from deepspeed_tpu_torch.module_inject import (load_lora_adapter, pack_lora_pages,
                                               validate_lora_adapter)
from deepspeed_tpu_torch.runtime.swap_tensor import SwapBufferPool
from deepspeed_tpu_torch.utils import fault_injection as fi

from tests._torch_threads import one_torch_thread  # noqa: F401

MHA = dict(family="llama", num_layers=2, hidden_size=8, num_heads=2, num_kv_heads=2,
           head_dim=4, vocab_size=64)
# 4 query heads over 2 kv heads: q/o are [16, 16], k/v [16, 8] (padded to 16)
GQA = dict(family="llama", num_layers=3, hidden_size=16, num_heads=4, num_kv_heads=2,
           head_dim=4, vocab_size=64)
SPEC = RaggedModelSpec(**MHA, dtype=torch.float32)
JSPEC = JaxSpec(**MHA, dtype=jnp.float32)
TARGETS = ("q", "v")     # both [8, 8] under SPEC


def _pair(din=8, dout=8, r=2, seed=0):
    g = np.random.RandomState(seed)
    return {"A": g.standard_normal((din, r)).astype(np.float32),
            "B": g.standard_normal((r, dout)).astype(np.float32)}


def _registry(pool_pages=4, ranks=(2, 2, 2), max_rank=4, dtype=torch.float32):
    """Adapters ``a0, a1, ...`` with seeded random masters over a small CPU
    pool (sum(ranks) > pool_pages is the interesting regime)."""
    spec = RaggedModelSpec(**MHA, dtype=dtype)
    pool = LoraPagePool(spec, TARGETS, pool_pages, "cpu")
    reg = LoraAdapterRegistry(pool, swap_buffers=8, max_rank=max_rank)
    for i, r in enumerate(ranks):
        g = np.random.RandomState(i)
        reg.register(f"a{i}", g.standard_normal((r, pool.elements)).astype(np.float32))
    return reg


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


# --------------------------------------------------------------------- #
# pool and registry
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_page_roundtrip_byte_exact(dtype):
    pool = LoraPagePool(RaggedModelSpec(**MHA, dtype=dtype), TARGETS, 8, "cpu")
    assert pool.elements == JaxPool(JSPEC, TARGETS, 8).elements
    rows = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (3, pool.elements)).astype(np.float32)).to(dtype)
    ids = pool.alloc(3)
    pool.put_pages(rows, ids)
    back = pool.fetch_pages(ids)
    assert back.dtype == dtype and _bytes(back) == _bytes(rows)
    # the zero page really is zeros (the inert-delta sentinel); pad writes
    # of a 3-page put landed on the junk page, not the zero page
    assert not pool.fetch_pages([pool.zero_page]).any()
    pool.free(ids)
    assert pool.free_pages == 8


def test_pool_alloc_overcommit_refused():
    pool = LoraPagePool(SPEC, TARGETS, 2, "cpu")
    with pytest.raises(RuntimeError) as port_err:
        pool.alloc(3)
    with pytest.raises(RuntimeError) as jax_err:
        JaxPool(JSPEC, TARGETS, 2).alloc(3)
    assert str(port_err.value) == str(jax_err.value)
    assert "pool exhausted" in str(port_err.value)


def test_registry_lru_eviction_and_byte_exact_restore():
    reg = _registry(pool_pages=4, ranks=(2, 2, 2))
    master0 = reg._adapters["a0"].master.clone()
    reg.acquire(1, "a0")
    reg.release(1)
    reg.acquire(2, "a1")
    reg.release(2)                       # pool full: a0 + a1 resident, idle
    assert reg.pool.free_pages == 0
    reg.acquire(3, "a2")                 # faults in by evicting the LRU a0
    assert not reg.is_resident("a0") and reg.is_resident("a2")
    assert reg._adapters["a0"].state == EVICTED and reg.swap.outstanding == 2
    assert reg.stats.adapters["a0"].evictions == 1
    reg.release(3)
    # restore: the pinned-buffer scatter back is byte-exact with the master
    reg.acquire(4, "a0")
    back = reg.pool.fetch_pages(reg._adapters["a0"].page_ids)
    assert _bytes(back) == _bytes(master0)
    assert reg.stats.adapters["a0"].faults == 2      # cold + restore
    # a0's buffers went back; the restore parked the LRU a1's instead
    assert reg._adapters["a1"].state == EVICTED and reg.swap.outstanding == 2
    reg.release(4)
    reg.close()                          # returns pages AND pinned buffers
    assert reg.pool.free_pages == 4 and reg.swap.outstanding == 0


def test_refcount_gates_eviction_and_can_admit_releasing():
    reg = _registry(pool_pages=4, ranks=(2, 2, 2))
    reg.acquire(1, "a0")
    reg.acquire(2, "a1")                 # pool full, every page pinned
    with pytest.raises(RuntimeError, match="cannot evict"):
        reg.evict("a0")
    assert not reg.can_admit("a2")
    with pytest.raises(RuntimeError, match="pool pressure"):
        reg.acquire(3, "a2")
    # the failed acquire rolled its binding back
    assert reg.binding(3) is None and reg.refcount("a2") == 0
    # the planner's simulation: releasing uid 1 would make a0 evictable
    assert reg.can_admit("a2", releasing=[1])
    reg.release(1)
    reg.acquire(3, "a2")                 # now funded by evicting the idle a0
    assert not reg.is_resident("a0")
    with pytest.raises(KeyError, match="unknown LoRA adapter"):
        reg.acquire(9, "nope")
    reg.release(2)
    reg.release(3)
    assert reg.drain_swap() == 2 and reg._adapters["a0"].state == REGISTERED
    assert reg.swap.outstanding == 0


def test_cancel_while_faulting_rolls_back_to_baseline():
    reg = _registry(pool_pages=4, ranks=(2, 2))
    free0 = reg.pool.free_pages
    fi.install(fi.parse_plan("serve.lora_fault:at=1"))
    try:
        with pytest.raises(fi.InjectedFault):
            reg.acquire(1, "a0")
    finally:
        fi.clear()
    # rollback: pages freed, binding undone, refcount at baseline
    assert reg.pool.free_pages == free0
    assert reg.refcount("a0") == 0 and reg.binding(1) is None
    assert not reg.is_resident("a0")
    reg.acquire(1, "a0")                 # a clean retry succeeds
    assert reg.is_resident("a0") and reg._adapters["a0"].state == RESIDENT
    reg.release(1)


def test_registry_metadata_reads_survive_a_mutating_engine_thread():
    """Readers on another thread (names, can_admit, rank, refcount) against
    a register / acquire / release / unregister churn loop: no error on
    either side."""
    reg = _registry(ranks=(2,))
    stop = threading.Event()
    errs = []

    def engine_mutator():
        i = 0
        try:
            while not stop.is_set():
                name = f"churn{i % 16}"
                reg.register(name, None)    # rank-0: pure metadata churn
                reg.acquire(30_000 + i, name)
                reg.release(30_000 + i)
                reg.unregister(name)
                i += 1
        except BaseException as exc:        # surfaced to the assert below
            errs.append(exc)

    t = threading.Thread(target=engine_mutator, name="engine-fake")
    t.start()
    deadline = time.monotonic() + 1.0
    try:
        while time.monotonic() < deadline and not errs:
            assert "a0" in reg.names
            assert reg.can_admit("a0")
            assert reg.rank("a0") == 2
            assert reg.refcount("a0") == 0
    except BaseException as exc:
        errs.append(exc)
    finally:
        stop.set()
        t.join(10.0)
    assert not errs, errs


def test_registry_refusals_in_jax_words():
    """The registry's own refusals (payload shape, rank past the pool and
    past max_rank, a re-register while bound) word for word."""
    port = _registry(pool_pages=4, ranks=(2,), max_rank=3)
    jpool = JaxPool(JSPEC, TARGETS, 4)
    jax_reg = JaxRegistry(jpool, swap_buffers=8, max_rank=3)
    jax_reg.register("a0", np.asarray(port._adapters["a0"].master))
    cases = [("bad", np.zeros((2, 5), np.float32)),
             ("big", np.zeros((5, jpool.elements), np.float32)),
             ("r4", np.zeros((4, jpool.elements), np.float32))]
    for name, payload in cases:
        with pytest.raises(ValueError) as port_err:
            port.register(name, payload)
        with pytest.raises(ValueError) as jax_err:
            jax_reg.register(name, payload)
        assert str(port_err.value) == str(jax_err.value)
    port.acquire(5, "a0")
    jax_reg.acquire(5, "a0")
    other = np.ones((2, jpool.elements), np.float32)
    with pytest.raises(ValueError) as port_err:
        port.register("a0", other)
    with pytest.raises(ValueError) as jax_err:
        jax_reg.register("a0", other)
    assert str(port_err.value) == str(jax_err.value)
    assert "must wait until they finish" in str(port_err.value)
    # an identical payload re-registers as a no-op, even while bound
    port.register("a0", port._adapters["a0"].master.clone())
    port.release(5)
    port.register("a0", other)           # idle now: replaced in place
    assert torch.equal(port._adapters["a0"].master, torch.from_numpy(other))
    with pytest.raises(RuntimeError) as port_err:
        load_lora_adapter(type("Plain", (), {"lora": None})(), "x", {})
    with pytest.raises(RuntimeError) as jax_err:
        jax_load(type("Plain", (), {"lora": None})(), "x", {})
    assert str(port_err.value) == str(jax_err.value)


def test_swap_buffer_pool_outstanding_and_views():
    pool = SwapBufferPool(max_buffers=2)
    a, b = pool.get(10), pool.get(5000)
    assert a.numel() == 4096 and b.numel() == 8192 and pool.outstanding == 2
    v = pool.view(b, (3, 4), torch.bfloat16)
    v.fill_(1.5)
    assert v.shape == (3, 4) and b[:24].view(torch.bfloat16).eq(1.5).all()
    pool.put(a)
    pool.put(b)
    assert pool.outstanding == 0 and pool.get(100) is a    # reused, not made anew


# --------------------------------------------------------------------- #
# the loader: refusals, layout, packing
# --------------------------------------------------------------------- #

def _per_layer(L, r=2, din=8, dout=8, seed=2):
    g = np.random.RandomState(seed)
    return {"A": g.standard_normal((L, din, r)).astype(np.float32),
            "B": g.standard_normal((L, r, dout)).astype(np.float32)}


REFUSALS = {
    "untargeted": ({"o": _pair()}, {}, "applies LoRA to"),
    "missing_b": ({"q": {"A": _pair()["A"]}}, {}, "the PEFT layout"),
    "not_a_dict": ({"q": [1, 2]}, {}, "the PEFT layout"),
    "a_shape": ({"q": _pair(din=7)}, {}, "shape/sharding mismatch"),
    "b_shape": ({"q": _pair(dout=9)}, {}, "shape/sharding mismatch"),
    "ab_rank": ({"q": {"A": _pair(r=2)["A"], "B": _pair(r=3)["B"]}}, {},
                "A rank 2 != B rank 3"),
    "ranks_across_targets": ({"q": _pair(r=2), "v": _pair(r=3, seed=1)}, {},
                             "one adapter, one rank"),
    "past_max_rank": ({"q": _pair(r=5)}, {"max_rank": 4}, "program grid stops there"),
    "per_layer_mixed": ({"q": {"A": _per_layer(2)["A"], "B": _per_layer(2)["B"][0]}}, {},
                        "leading axis on BOTH"),
    "per_layer_wrong_l": ({"q": _per_layer(1)}, {}, "leading axis on BOTH"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_loader_refusals_in_jax_words(case):
    state, kw, words = REFUSALS[case]
    with pytest.raises(ValueError) as port_err:
        validate_lora_adapter(SPEC, TARGETS, state, name="t", **kw)
    with pytest.raises(ValueError) as jax_err:
        jax_validate(JSPEC, TARGETS, state, name="t", **kw)
    assert str(port_err.value) == str(jax_err.value)
    assert words in str(port_err.value)


def test_loader_accepts_what_jax_accepts():
    state = {"q": _pair(r=3), "v": _pair(r=3, seed=1)}
    assert validate_lora_adapter(SPEC, TARGETS, state) == 3
    assert validate_lora_adapter(SPEC, TARGETS, {"q": _pair(r=5)}, max_rank=5) == 5
    assert validate_lora_adapter(SPEC, TARGETS, {"q": _per_layer(2)}) == 2
    # torch leaves read as numpy ones
    tstate = {t: {k: torch.from_numpy(v) for k, v in p.items()} for t, p in state.items()}
    assert validate_lora_adapter(SPEC, TARGETS, tstate) == 3
    assert validate_lora_adapter(SPEC, TARGETS, {}) == 0
    assert pack_lora_pages(SPEC, TARGETS, {}) is None
    assert jax_pack(JSPEC, TARGETS, {}) is None


@pytest.mark.parametrize("geometry", ["mha", "gqa"])
def test_page_layout_and_packing_match_jax(geometry):
    """All four targets: flat leaves, a per-layer leaf, an absent target
    (zero), alpha folded into B; the same pages as the JAX package's, and
    in bf16 the same rounding."""
    geo = MHA if geometry == "mha" else GQA
    spec, jspec = RaggedModelSpec(**geo, dtype=torch.float32), JaxSpec(**geo, dtype=jnp.float32)
    for targets in (("q", "v"), LORA_TARGETS, ("k", "o")):
        assert lora_page_layout(spec, targets) == jax_layout(jspec, targets)
    assert lora_target_dims(spec, "k") == (geo["hidden_size"],
                                           geo["num_kv_heads"] * geo["head_dim"])
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora_target_dims(spec, "w_up")
    L, hid = geo["num_layers"], geo["hidden_size"]
    qd, kvd = geo["num_heads"] * geo["head_dim"], geo["num_kv_heads"] * geo["head_dim"]
    state = {"q": _pair(hid, qd, r=3, seed=1), "k": _per_layer(L, 3, hid, kvd, seed=3),
             "o": _pair(qd, hid, r=3, seed=4), "alpha": 6.0}
    pages = pack_lora_pages(spec, LORA_TARGETS, state)
    ref = jax_pack(jspec, LORA_TARGETS, state)
    assert pages.dtype == torch.float32 and pages.shape == ref.shape
    assert np.array_equal(pages.numpy(), ref)
    _, in_max, out_max = lora_page_layout(spec, LORA_TARGETS)
    grid = pages.reshape(3, L, 4, in_max + out_max)
    assert not grid[:, :, 2].any()                                  # v absent
    assert np.allclose(grid[1, 0, 0, in_max:in_max + qd], state["q"]["B"][1] * 2.0)
    if geometry == "gqa":       # k's B rows pad from kvd to out_max with zeros
        assert not grid[:, :, 1, in_max + kvd:].any()
    bf16 = pack_lora_pages(spec, LORA_TARGETS, state, alpha=1.0, dtype=torch.bfloat16)
    jbf16 = jax_pack(jspec, LORA_TARGETS, state, alpha=1.0, dtype=jnp.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert np.array_equal(bf16.view(torch.int16).numpy(), np.asarray(jbf16).view(np.int16))
    # without alpha (argument or key) the scale is 1
    plain = {k: v for k, v in state.items() if k != "alpha"}
    assert np.array_equal(pack_lora_pages(spec, LORA_TARGETS, plain).numpy(),
                          jax_pack(jspec, LORA_TARGETS, plain))
