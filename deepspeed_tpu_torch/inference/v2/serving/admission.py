"""Multi-tenant admission: priority classes, SLO cost model, preemption plan
(the JAX package's ``serving/admission.py``, copied).

The frontend's engine thread calls :meth:`AdmissionController.plan` once per
iteration (between ``DecodePipeline.run`` bursts). The controller owns the
pending queues — one FIFO per priority class, strict priority between
classes — and turns queue state + pool capacity into an ordered action list
the frontend executes verbatim:

    [("shed", req), ("restore", req), ("preempt", victim), ("admit", req)]

Decisions (Orca/FastGen-style iteration-level scheduling, vLLM-style
preemption):

- **shed**: a queued request whose *best-case* TTFT already misses its class
  SLO — ``elapsed + predicted_prefill + one_slice > ttft_slo * shed_factor``
  — is rejected now, before its prefill burns device time on a guaranteed
  miss (the load-shedding half of goodput-under-SLO). Predictions come from
  :class:`CostModel`, an EMA over *measured* prefill throughput and slice
  wall time; until the first measurement the model predicts 0 and nothing
  is shed.
- **restore**: preempted requests re-enter — highest class first, oldest
  preemption first — whenever spare capacity (beyond the live set's
  next-slice funding) covers their pages. Restores outrank new admissions,
  so a victim is never starved by the class that preempted it.
- **admit**: strict ``(priority desc, FIFO)`` order, head-of-line blocking
  within the whole queue (no bypass — a lower class never jumps a held
  higher-class request). A request is admitted when the pool funds its
  prompt plus near-term decode growth and a decode row is free; under
  ``preemption: "none"`` the funding test is the request's FULL
  ``prompt + max_new_tokens`` KV lifetime (conservative reject-only
  admission — nothing can be evicted later, so nothing optimistic is
  admitted).
- **preempt**: when an admit (or the live set's own next-slice funding)
  doesn't fit, victims are chosen strictly-lower-priority-first, newest
  admission first within a class (LIFO — preserves older requests'
  progress), and only for a strictly higher-priority requester. The
  frontend offloads each victim's private KV tail (``kv_offload.py``),
  falling back to recompute when host capacity is exhausted.

Multi-tenant LoRA joins the same plan: a request bound to an adapter
(``RequestHandle.adapter``) admits/restores only when its adapter is
fundable in the ADAPTER page pool too (``LoraAdapterRegistry.can_admit`` —
resident, or free + idle-evictable pages cover its rank), and adapter pool
pressure preempts strictly-lower-priority binding holders exactly like KV
pressure preempts block holders. The frontend then acquires the binding in
the admission round — the fault-in (host -> device page scatter) lands
there, never inside a decode slice, so a cold adapter can't stall a hot
tenant's token cadence.

Everything here is host metadata — the controller never touches a device
tensor; block math rides the scheduler's refcounted accounting
(``scheduler.available_blocks`` / ``blocks_needed``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.inference.v2.config_v2 import ServingConfig


class CostModel:
    """EMA queue-delay + prefill-cost model behind admit/hold/shed.

    Two measured rates, updated by the frontend from wall-clock it already
    takes: ``prefill_tok_s`` (prompt tokens through scheduler passes per
    second) and ``slice_s`` (one decode-slice ``run()`` burst). Predictions
    are conservative best-case: a request admitted *now* sees its own
    prefill plus one slice boundary before its first token drains."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self.prefill_tok_s: Optional[float] = None
        self.slice_s: Optional[float] = None

    def _ema(self, cur: Optional[float], obs: float) -> float:
        return obs if cur is None else (1 - self.alpha) * cur + self.alpha * obs

    def update_prefill(self, tokens: int, secs: float) -> None:
        if tokens > 0 and secs > 0:
            self.prefill_tok_s = self._ema(self.prefill_tok_s, tokens / secs)

    def update_decode(self, secs: float) -> None:
        if secs > 0:
            self.slice_s = self._ema(self.slice_s, secs)

    def predicted_ttft_s(self, prompt_tokens: int) -> float:
        p = prompt_tokens / self.prefill_tok_s if self.prefill_tok_s else 0.0
        return p + (self.slice_s or 0.0)


Action = Tuple[str, object]     # ("shed"|"restore"|"preempt"|"admit", req)


class AdmissionController:

    def __init__(self, engine, config: ServingConfig):
        self.engine = engine
        self.config = config
        self.cost = CostModel()
        # one FIFO per class, iterated in strict priority order
        self._order = sorted(config.classes, key=lambda c: -c.priority)
        self._queues: Dict[str, Deque] = {c.name: deque() for c in self._order}
        # per-class queue-delay EMA (arrival -> admit), updated as plans
        # admit: the federation signal a multi-replica ServingRouter
        # aggregates across replicas — a hot replica's rising delay steers
        # new arrivals to a cold one before the local shed rule ever fires
        self._qdelay: Dict[str, Optional[float]] = {
            c.name: None for c in self._order}

    # ------------------------------------------------------------------ #
    # queue management (engine thread only)
    # ------------------------------------------------------------------ #

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def slice_tokens(self) -> int:
        """KV tokens one decode slice reserves per row (the per-run
        ``decode_batch`` reservation the funding math must match): the
        plain pipeline reserves ``decode_slice + 1``; speculative decoding
        reserves for FULL acceptance — ``decode_slice * (k + 1) + 1`` —
        with run-end rollback returning what rejection left unused. A
        frontend pinned to the plain pipeline via ``ServingConfig.spec =
        False`` funds at the plain rate even on a spec-enabled engine
        (funding at the spec rate would over-reserve ~(k+1)x and preempt
        or shed requests the pool can actually serve)."""
        sd = self.engine.config.spec_decode
        mult = sd.k + 1 if (sd.enabled and self.config.spec) else 1
        return self.config.decode_slice * mult + 1

    def enqueue(self, req) -> bool:
        """False = queue full; the caller sheds the request immediately."""
        if self.queued >= self.config.max_queue:
            return False
        self._queues[req.cls.name].append(req)
        return True

    def remove(self, req) -> None:
        q = self._queues[req.cls.name]
        try:
            q.remove(req)
        except ValueError:
            pass                      # already popped by a plan

    def _iter_queued(self):
        """Queued requests in strict (priority desc, FIFO) order."""
        for cls in self._order:
            for req in self._queues[cls.name]:
                yield req

    # ------------------------------------------------------------------ #
    # the planner
    # ------------------------------------------------------------------ #

    def _blocks(self, n_tokens: int) -> int:
        bs = self.engine.kv.config.block_size
        return -(-int(n_tokens) // bs)

    def _admit_cost(self, req, slice_tokens: int) -> int:
        """Blocks an admission must fund up front. Preemptive modes admit
        optimistically (prompt + one slice of decode growth); reject-only
        funds the full KV lifetime — with no eviction lever, optimism would
        strand the live set mid-decode."""
        if self.config.preemption == "none":
            return self._blocks(len(req.prompt) + req.max_new_tokens + 1)
        return self._blocks(len(req.prompt) + slice_tokens)

    def _restore_cost(self, req, offload, slice_tokens: int) -> int:
        """Blocks a restore consumes: the offloaded page count (offload) or
        a full re-prefill of prompt + generated-so-far (recompute), plus a
        slice of growth either way."""
        grow = self._blocks(slice_tokens)
        if offload is not None and req.uid in offload._recs:
            return offload.pages_held(req.uid) + grow
        return self._blocks(len(req.prompt) + len(req.tokens) + 1) + grow

    def _freeable(self, uid: int) -> int:
        """Pool blocks preempting ``uid`` returns right now: its private
        tail (offload/recompute both free exactly these to the free list;
        shared-prefix pages only move to the radix tree, where they are
        already counted evictable)."""
        return len(self.engine.scheduler.private_tail(uid)[1])

    def queue_delay_s(self, cls_name: str) -> float:
        """The class's admitted queue-delay EMA in seconds (0 until the
        first admission) — read by ``ServingRouter`` for federated
        placement/shedding; see ``_qdelay`` above."""
        return self._qdelay.get(cls_name) or 0.0

    def _note_queue_delay(self, cls_name: str, delay_s: float) -> None:
        a = self.cost.alpha
        cur = self._qdelay[cls_name]
        self._qdelay[cls_name] = delay_s if cur is None \
            else (1 - a) * cur + a * delay_s

    def hopeless(self, req, now: float) -> bool:
        """Best-case TTFT already misses the class SLO: shed, don't burn."""
        elapsed = now - req.arrival_t
        predicted = self.cost.predicted_ttft_s(len(req.prompt))
        return (elapsed + predicted) * 1e3 > \
            req.cls.ttft_slo_ms * self.config.shed_factor

    def plan(self, now: Optional[float], live: Dict[int, object],
             preempted: Dict[int, object], offload=None) -> List[Action]:
        """One admission round's ordered action list (see module docstring).
        ``live``/``preempted`` map uid -> request for the frontend's current
        decoding / preempted sets; ``offload`` is the KVOffloadManager (None
        under recompute/none preemption)."""
        if now is None:
            now = time.perf_counter()
        cfg = self.config
        sched = self.engine.scheduler
        sm = self.engine.config.state_manager
        slice_tokens = self.slice_tokens
        actions: List[Action] = []

        # simulated capacity: every planned action moves these two counters,
        # so one plan never over-commits what its own admissions consume
        budget = sched.available_blocks \
            - sched.blocks_needed(list(live), slice_tokens)
        rows_free = sm.max_ragged_sequence_count - len(live)
        slots_free = sm.max_tracked_sequences - len(sched.seqs)

        # 0. sheds: SLO-hopeless queued requests, any class
        for req in list(self._iter_queued()):
            if req.cancelled:
                self.remove(req)      # frontend finalizes via its own sweep
            elif self.hopeless(req, now):
                self.remove(req)
                actions.append(("shed", req))

        # adapter-aware planning: admits/restores of LoRA-bound requests
        # also need their adapter fundable in the ADAPTER page pool
        # (resident, or free + idle-evictable pages >= rank) — checked with
        # the same simulate-the-plan discipline as the block budget, where
        # a planned preempt releases its victim's adapter binding
        lora = getattr(self.engine, "lora", None)
        releasing: List[int] = []

        def _adapter_ok(req) -> bool:
            a = getattr(req, "adapter", None)
            if a is None or lora is None:
                return True
            return lora.can_admit(a, releasing=releasing)

        # 1. restores outrank admissions (priority desc, oldest preempt first)
        order = {c.name: i for i, c in enumerate(self._order)}
        for req in sorted(preempted.values(),
                          key=lambda r: (order[r.cls.name], r.preempt_t)):
            if req.cancelled or rows_free <= 0:
                continue
            if not _adapter_ok(req):
                continue      # adapter pool pressure: stay preempted
            # a recompute-preempted victim was flushed — readmitting it
            # re-creates its sequence, so it needs a tracked slot too
            needs_slot = offload is None or req.uid not in offload._recs
            if needs_slot and slots_free <= 0:
                continue
            cost = self._restore_cost(req, offload, slice_tokens)
            if cost <= budget:
                actions.append(("restore", req))
                budget -= cost
                rows_free -= 1
                slots_free -= needs_slot

        # 2. admits: strict priority FIFO with head-of-line blocking;
        #    preemption may fund a strictly-higher-priority head
        # pop() takes from the END: sort so the tail is (lowest priority,
        # NEWEST admission) — LIFO within a class preserves older requests'
        # progress (a 90-token victim loses more than a 2-token one)
        victims = sorted(
            (r for r in live.values()),
            key=lambda r: (order[r.cls.name], r.admit_t))
        for req in list(self._iter_queued()):
            if req.cancelled:
                continue
            if rows_free <= 0 or slots_free <= 0:
                break
            need = self._admit_cost(req, slice_tokens)
            while need > budget and cfg.preemption != "none" and victims:
                v = victims[-1]
                if v.cls.priority >= req.cls.priority:
                    break             # never preempt same-or-higher priority
                victims.pop()
                gain = self._freeable(v.uid)
                if gain <= 0 and rows_free > 0:
                    continue          # nothing to reclaim from this victim
                actions.append(("preempt", v))
                budget += gain
                rows_free += 1
                releasing.append(v.uid)
            # adapter pool pressure funds the same way KV pressure does:
            # preempt strictly-lower-priority rows whose released bindings
            # make enough idle pages evictable — but only rows that HOLD an
            # adapter binding (an adapterless victim frees no adapter pages)
            while not _adapter_ok(req) and cfg.preemption != "none" \
                    and victims:
                v = victims[-1]
                if v.cls.priority >= req.cls.priority:
                    break
                victims.pop()
                if getattr(v, "adapter", None) is None:
                    continue
                actions.append(("preempt", v))
                budget += self._freeable(v.uid)
                rows_free += 1
                releasing.append(v.uid)
            if not _adapter_ok(req):
                break                 # head-of-line holds; no bypass
            if need <= budget:
                self.remove(req)
                actions.append(("admit", req))
                # intentionally async: queue delay is host wall time the
                # request ALREADY waited (arrival -> this admit), no device
                # work is being timed
                self._note_queue_delay(req.cls.name, now - req.arrival_t)
                budget -= need
                rows_free -= 1
                slots_free -= 1
            else:
                break                 # head-of-line holds; no bypass
        return actions

    def slice_shortfall(self, live_uids: List[int]) -> int:
        """Blocks the NEXT decode slice still needs beyond what the pool can
        provide — the frontend's pre-run emergency-preemption trigger (>0
        only when optimistic admission outran generation-driven growth)."""
        need = self.engine.scheduler.blocks_needed(
            list(live_uids), self.slice_tokens)
        return need - self.engine.scheduler.available_blocks
