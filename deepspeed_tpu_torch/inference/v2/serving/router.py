"""Multi-replica serving router: cache-aware routing, federated SLO
admission, disaggregated prefill/decode (the JAX package's
``serving/router.py``, ported).

This layer makes N engines one service, so capacity comes from adding
replicas instead of inflating one batch. A :class:`ServingRouter` fronts a :class:`ServingCluster` with the
``ServingFrontend.submit`` signature — ``submit(prompt, priority,
max_new_tokens) -> RequestHandle`` — and the handle's stream/cancel/result
semantics pass through UNCHANGED whichever replica serves it.

Three mechanisms (``config_v2.RouterConfig``):

- **Cache-aware routing** (the SGLang-RadixAttention trick at cluster
  scope): a :class:`ClusterPrefixIndex` — chain hashes of token-block paths,
  fed by per-replica insert/evict deltas from ``prefix_cache.py`` — answers
  "which replica already computed this prompt's prefix". Placement maximises
  ``cached_tokens - balance * outstanding``: sticky enough that one replica
  amortises a shared system prompt across every request carrying it, with
  the ``balance`` knob trading stickiness against load spread. The index is
  a HINT: a stale entry (evicted since the last delta) costs a mis-route,
  never correctness — the replica's own ``match`` decides what attaches.

- **Federated admission**: each replica's ``AdmissionController`` already
  keeps the class's queue-delay EMA and a measured prefill/slice cost model;
  the router reads them ALL, skips replicas whose predicted TTFT for this
  request already busts the class SLO (a hot replica sheds load to a cold
  one by never receiving it), and sheds AT THE ROUTER — before any prefill
  burns device time — when every candidate is hot.

- **Disaggregated prefill/decode** (``topology: "disaggregated"``):
  dedicated prefill replicas run SplitFuse passes (``cluster.PrefillWorker``)
  and hand each finished sequence to a decode replica over the KV page
  fabric — ``engine.export_kv`` (one bucketed page gather + the bootstrap
  logits row, the exact record preempt-offload parks) into
  ``engine.import_kv`` on the decode engine (fresh pool ids, byte-exact
  content, ``_last_logits`` re-seeded like a preemption restore). Decode
  replicas then never run a prefill pass, which keeps prefill out of
  decode TBT.

Observability: ``serve/router/*`` counters (``monitor/serving.RouterStats``
— placement, cache hits, rebalances, handoff traffic, per-class CLUSTER
goodput rollups) plus ``serve/router/{route,handoff}`` trace spans on a
``serve/router`` lane; replicas' own surfaces carry their replica label.

Fault tolerance (``RouterConfig.health``): a :class:`~deepspeed_tpu_torch.inference.v2.serving.health.
HealthMonitor` walks replicas through ``healthy -> suspect -> down ->
draining -> rejoining`` — engine-thread/worker liveness plus a decode-step
progress heartbeat with a stall deadline — fences a failed replica,
migrates its in-flight requests to survivors (salvaging preempt-offloaded
KV through the page fabric, re-prefilling sealed histories otherwise), and
self-heals by rebuilding + re-warming a frontend on the recovered engine.
Routing never places a request on a non-``healthy`` replica, and a closed
or crashed replica's prefix-index entries are evicted so stale cache
affinity cannot keep attracting routes.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.config_v2 import RouterConfig
from deepspeed_tpu_torch.inference.v2.prefix_cache import ROOT_CHAIN, chain_hash
from deepspeed_tpu_torch.inference.v2.serving.admission import CostModel
from deepspeed_tpu_torch.inference.v2.serving.cluster import (PrefillWorker,
                                                        Replica,
                                                        ServingCluster)
from deepspeed_tpu_torch.inference.v2.serving.frontend import _DONE, RequestHandle
from deepspeed_tpu_torch.inference.v2.serving.health import HEALTHY, HealthMonitor
from deepspeed_tpu_torch.monitor.serving import RouterStats
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.threads import make_lock


class ClusterPrefixIndex:
    """Shared radix-prefix membership index over token-block chain hashes.

    One dict: ``chain_hash -> {replica names holding that cached path}``,
    maintained from each replica's ``RadixPrefixCache.add_listener`` deltas
    (insert/evict of full-block nodes; the listener replays existing state
    at registration, so a router built over warm replicas starts
    consistent). ``match`` walks a prompt's blocks with the SAME chain
    function the trees use, so membership == path existence — no tree is
    ever locked or walked across threads. O(prompt blocks) per query,
    O(cached blocks x replicas) memory, one lock (deltas are engine-thread
    writes; matches are client-thread reads)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._lock = make_lock("serving.router.prefix_index")
        self._chains: Dict[int, set] = {}

    def listener(self, replica: str):
        """The delta sink to register on one replica's prefix cache."""
        def on_delta(op: str, chain: int) -> None:
            self.apply(replica, op, chain)
        return on_delta

    def apply(self, replica: str, op: str, chain: int) -> None:
        with self._lock:
            if op == "insert":
                self._chains.setdefault(chain, set()).add(replica)
            else:
                holders = self._chains.get(chain)
                if holders is not None:
                    holders.discard(replica)
                    if not holders:
                        del self._chains[chain]

    @property
    def chains(self) -> int:
        with self._lock:
            return len(self._chains)

    def drop_replica(self, replica: str) -> int:
        """Evict EVERY chain entry held by ``replica`` — a closed or failed
        replica's cached paths must stop attracting routes immediately (its
        delta feed is gone, so the entries would otherwise stay stale
        forever). Returns entries dropped."""
        with self._lock:
            dropped = 0
            for chain in list(self._chains):
                holders = self._chains[chain]
                if replica in holders:
                    holders.discard(replica)
                    dropped += 1
                    if not holders:
                        del self._chains[chain]
            return dropped

    def holders(self, replica: str) -> int:
        """Entries currently attributed to ``replica`` (tests/stats)."""
        with self._lock:
            return sum(1 for h in self._chains.values() if replica in h)

    def match(self, tokens: Sequence[int]) -> Dict[str, int]:
        """Per-replica longest cached match, in TOKENS (whole blocks only,
        capped at ``len(tokens) - 1`` exactly like the trees' ``match``).
        Replicas with no match are absent from the result."""
        tokens = [int(t) for t in np.asarray(tokens, np.int64).reshape(-1)]
        bs = self.block_size
        limit = len(tokens) - 1
        best: Dict[str, int] = {}
        chain = ROOT_CHAIN
        i = 0
        with self._lock:
            while i + bs <= limit:
                chain = chain_hash(chain, tuple(tokens[i:i + bs]))
                holders = self._chains.get(chain)
                if not holders:
                    break
                i += bs
                for name in holders:
                    best[name] = i
        return best


class ServingRouter:

    def __init__(self, cluster: ServingCluster, config=None):
        cfg = config if config is not None else RouterConfig()
        if isinstance(cfg, dict):
            cfg = RouterConfig(**cfg)
        self.cluster = cluster
        self.config = cfg
        if cfg.topology == "disaggregated":
            if not cluster.prefill_replicas or not cluster.decode_replicas:
                raise ValueError(
                    "disaggregated topology needs >= 1 'prefill' and >= 1 "
                    "'decode' replica; got roles "
                    f"{[r.role for r in cluster.replicas]}")
            self._targets = cluster.prefill_replicas
            self._decode = cluster.decode_replicas + cluster.serve_replicas
        else:
            if cluster.prefill_replicas or cluster.decode_replicas:
                raise ValueError(
                    "colocated topology takes only 'serve' replicas; got "
                    f"roles {[r.role for r in cluster.replicas]}")
            self._targets = cluster.serve_replicas
            self._decode = cluster.serve_replicas
        if not self._targets or not self._decode:
            raise ValueError("router needs at least one routable replica")
        # all frontends share one ServingConfig (cluster builds them so);
        # class lookups and SLO bounds read from the first
        self._serving_cfg = self.cluster.frontends[0].frontend.config
        self.stats = RouterStats([r.name for r in cluster.replicas],
                                 [c.name for c in self._serving_cfg.classes])
        for r in cluster.frontends:
            self.stats.register_frontend(r.frontend.stats)
        # the shared prefix index, fed by every routable replica's radix
        # tree (replicas without a prefix cache simply never match)
        self.index = ClusterPrefixIndex(cluster.block_size)
        self._listeners: List[Tuple[str, object, object]] = []
        for r in self._targets:
            self._register_index_listener(r)
        # a replica frontend closed OUT OF BAND (not through router.close)
        # must stop attracting routes and drop its index entries — the
        # listener-lifecycle fix the close-then-route regression test pins
        for r in cluster.frontends:
            self._register_close_listener(r)
        # prefill-replica cost models (fed by PrefillWorker measurements —
        # prefill replicas have no frontend, so federation reads these)
        self._prefill_cost: Dict[str, CostModel] = {
            r.name: CostModel() for r in cluster.prefill_replicas}
        self._workers: Dict[str, PrefillWorker] = {
            r.name: PrefillWorker(r, self) for r in cluster.prefill_replicas}
        self._lock = make_lock("serving.router.state")  # stats + rr + inflight
        self._rr = 0
        self._inflight = 0                 # requests held by prefill workers
        self._uids = itertools.count(1 << 44)   # never collides with the
        # frontends' per-replica (1 << 24)-spaced uid bases (cluster.py):
        # the cluster would need 2^20 frontend lifetimes to reach this
        self._closed = False
        # replica failure detection / failover / self-healing
        # (serving/health.py; no thread unless cfg.health.enabled)
        self.health = HealthMonitor(self, cfg.health)
        if self.health.enabled:
            # managed frontends keep streams OPEN across a loop crash — the
            # monitor migrates them instead of closing them
            for r in cluster.frontends:
                r.frontend._managed = True

    def _register_index_listener(self, r: Replica) -> None:
        if r.engine.prefix_cache is not None:
            fn = self.index.listener(r.name)
            r.engine.prefix_cache.add_listener(fn)
            self._listeners.append((r.name, r.engine.prefix_cache, fn))

    def _register_close_listener(self, r: Replica) -> None:
        r.frontend.add_close_listener(
            lambda name=r.name: self._replica_closed(name))

    def _replica_closed(self, name: str) -> None:
        """A replica frontend is closing (router teardown, an out-of-band
        close, or a failover fence->close): evict its prefix-index entries
        and stop feeding them — routing checks keep it out of rotation."""
        self._drop_replica_routing(name)

    def _drop_replica_routing(self, name: str) -> None:
        self.index.drop_replica(name)
        kept = []
        for rec in self._listeners:
            if rec[0] == name:
                rec[1].remove_listener(rec[2])
            else:
                kept.append(rec)
        self._listeners = kept

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def start(self) -> "ServingRouter":
        self.cluster.start()
        for w in self._workers.values():
            w.start()
        self.health.start()
        return self

    def __enter__(self) -> "ServingRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every routed request reaches a terminal state on its
        replica. A replica whose engine thread (or prefill worker) died
        raises HERE, NAMED — a dead replica must not look like a slow
        drain. True = drained; False = timed out."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self.check_health()
            busy = self._inflight > 0 or any(
                r.frontend._inflight > 0 for r in self.cluster.frontends)
            if not busy:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)

    def check_health(self) -> None:
        """Without a health monitor: raise, naming the replica, if any
        engine thread or prefill worker has died (a
        dead replica must not look like a slow drain). With monitoring
        enabled, failures are HANDLED — detected, fenced, migrated — so
        this only polls the monitor and re-raises if the monitor itself
        died."""
        if self.health.enabled:
            self.health.check()
            return
        for r in self.cluster.frontends:
            if r.frontend._loop_exc is not None:
                raise RuntimeError(
                    f"replica {r.name!r} serving loop died") \
                    from r.frontend._loop_exc
        for name, w in self._workers.items():
            if w.exc is not None:
                raise RuntimeError(
                    f"replica {name!r} prefill worker died") from w.exc

    def close(self) -> None:
        """Stop the health monitor and prefill workers, close every replica
        frontend (cancelling whatever is in flight), and deregister the
        prefix-index listeners. Idempotent; a died replica re-raises ONCE,
        named, after the whole cluster is torn down (a failure the health
        monitor already handled does not re-raise)."""
        if self._closed:
            return
        self._closed = True
        self.health.close()
        for w in self._workers.values():
            w.close()
        for _name, cache, fn in self._listeners:
            cache.remove_listener(fn)
        self._listeners = []
        self.cluster.close(ignore=self.health.handled_replicas())

    def rejoin(self, name: str) -> bool:
        """Re-admit a drained replica to routing (``serving/health.py``):
        reset its engine, rebuild its frontend in a fresh uid space, re-warm
        the program grids off the hot path, replay its radix tree into the
        prefix index. True once back in rotation."""
        return self.health.rejoin(name)

    # ------------------------------------------------------------------ #
    # client surface
    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int], priority: Optional[str] = None,
               max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               adapter: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Route one request and submit it; returns the serving replica's
        stream handle (identical semantics to ``ServingFrontend.submit``,
        including the adapter/tenant multi-tenant identity). May return an
        already-SHED handle when federation finds every candidate replica
        SLO-hopeless for this class. Adapter-bound requests route only to
        replicas with the adapter REGISTERED, and a replica with its pages
        already RESIDENT scores like a cache hit — the fleet converges on
        tenant-sticky placement without any explicit pinning."""
        if self._closed:
            raise RuntimeError("router is closed")
        cls = self._serving_cfg.class_for(priority,
                                          tenant if tenant is not None
                                          else adapter)
        if adapter is not None and self.config.topology != "colocated":
            raise NotImplementedError(
                "LoRA adapters over disaggregated prefill/decode are not "
                "wired (the handoff record carries no adapter binding); "
                "run topology='colocated'")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        t0 = time.perf_counter()
        matches = self.index.match(prompt) \
            if self.config.policy == "cache_aware" else {}
        excluded: List[str] = []
        while True:
            target, matched, rebalanced = self._choose(prompt, cls, matches,
                                                       exclude=excluded,
                                                       adapter=adapter)
            t1 = time.perf_counter()
            if target is None:
                # shed at the router: every candidate's predicted TTFT
                # busts the class SLO (federation), or no replica is
                # routable at all — reject before any prefill burns on it
                req = RequestHandle(next(self._uids), prompt, cls,
                                    int(max_new_tokens), eos_token_id, t0)
                if not getattr(self._serving_cfg, "attribution", True):
                    req._ledger = None
                with self._lock:
                    self.stats.router_sheds[cls.name] += 1
                self._finalize_external(req, "shed")
                if _tracer.enabled:
                    _tracer.add("serve/router/route", t0, t1,
                                lane="serve/router", outcome="shed",
                                uid=req.uid, trace_id=req.trace_id,
                                cls=cls.name)
                return req
            if self.config.topology == "colocated":
                # submit FIRST: a validation reject must not count as routed
                try:
                    handle = target.frontend.submit(
                        prompt, priority=priority,
                        max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id,
                        adapter=adapter, tenant=tenant)
                except RuntimeError:
                    # the replica went down between _choose and submit (a
                    # failure race, not a validation reject — those raise
                    # ValueError): re-route among the survivors
                    excluded.append(target.name)
                    continue
            else:
                try:
                    handle = self._submit_disaggregated(target, prompt, cls,
                                                        int(max_new_tokens),
                                                        eos_token_id, t0)
                except RuntimeError:
                    # the prefill worker was fenced between _choose and
                    # submit (validation rejects raise ValueError and
                    # propagate): re-route among the survivors
                    excluded.append(target.name)
                    continue
            break
        with self._lock:
            self.stats.routed[target.name] += 1
            if matched:
                self.stats.cache_hit_requests += 1
                self.stats.cache_hit_blocks += matched // self.index.block_size
            if rebalanced:
                self.stats.rebalances += 1
        if _tracer.enabled:
            # the flow chain's first hop: trace_id binds this placement
            # span to every later hop of the request across lanes/threads
            _tracer.add("serve/router/route", t0, t1, lane="serve/router",
                        replica=target.name, cached_tokens=matched,
                        uid=handle.uid, trace_id=handle.trace_id,
                        cls=cls.name)
        return handle

    def write_monitor_events(self, monitor, step: int = 0) -> None:
        """Emit the aggregated ``serve/router/*`` counters plus every
        replica's labelled ``serve/frontend/<replica>/*`` counters through
        one ``monitor/`` backend (``MonitorMaster.write_events`` shape) —
        the rows stay distinguishable by construction."""
        monitor.write_events(self.stats.events(step))
        if self.health.enabled or self.health.stats.migrations:
            monitor.write_events(self.health.stats.events(step))
        for r in self.cluster.frontends:
            r.frontend.write_monitor_events(monitor, step)

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #

    def _routable(self, r: Replica) -> bool:
        """May a NEW placement land on this replica? Closed/fenced/crashed
        frontends (and dead prefill workers) are out even without health
        monitoring — a stale prefix-index hit or round-robin turn must
        never route onto a corpse; with monitoring, only ``healthy``
        replicas (not suspect/down/draining/rejoining) take traffic."""
        if r.role == "prefill":
            w = self._workers[r.name]
            if w.exc is not None or w.fenced:
                return False
        else:
            fe = r.frontend
            if fe is None or fe._closed or fe._fenced \
                    or fe._loop_exc is not None:
                return False
        if self.health.enabled:
            return self.health.state(r.name) == HEALTHY
        return True

    def _load(self, r: Replica) -> int:
        if r.role == "prefill":
            return self._workers[r.name].queued \
                + len(r.engine.scheduler.seqs)
        # _inflight, not outstanding: submit bumps it SYNCHRONOUSLY, so a
        # burst of submits sees its own earlier placements — outstanding is
        # filed by the engine thread and lags by one control-drain
        return r.frontend._inflight

    def _hot(self, r: Replica, cls, prompt_len: int) -> bool:
        """Federation signal: would this replica's measured queue delay +
        prefill cost already bust the class's TTFT SLO? (0 until the
        replica's cost model warms — mirrors the local shed rule.) A
        prefill replica's queue delay is its worker backlog: each queued
        request prefills ahead of this one, so the prediction scales the
        measured per-prompt cost by the queue depth — without it a
        multi-second backlog would never shed a guaranteed TTFT miss."""
        if r.role == "prefill":
            per = self._prefill_cost[r.name].predicted_ttft_s(prompt_len)
            pred = per * (1 + self._workers[r.name].queued)
        else:
            adm = r.frontend.admission
            pred = adm.queue_delay_s(cls.name) \
                + adm.cost.predicted_ttft_s(prompt_len)
        return pred * 1e3 > cls.ttft_slo_ms * self.config.shed_factor

    def _adapter_state(self, r: Replica, adapter: str) -> int:
        """0 = the replica cannot serve this adapter (LoRA disabled or the
        adapter unregistered there), 1 = registered, 2 = registered with
        pages device-RESIDENT right now (no fault-in to admit)."""
        lora = getattr(r.engine, "lora", None)
        if lora is None or adapter not in lora.names:
            return 0
        return 2 if lora.is_resident(adapter) else 1

    def _choose(self, prompt, cls, matches: Dict[str, int],
                exclude: Sequence[str] = (),
                adapter: Optional[str] = None) \
            -> Tuple[Optional[Replica], int, bool]:
        """(target, cached tokens there, rebalanced?). ``None`` target =
        shed (every candidate hot, or no routable replica at all)."""
        cands = [r for r in self._targets
                 if r.name not in exclude and self._routable(r)]
        if adapter is not None:
            cands = [r for r in cands if self._adapter_state(r, adapter)]
            if not cands:
                raise KeyError(
                    f"LoRA adapter {adapter!r} is not registered on any "
                    "routable replica — load it (module_inject."
                    "load_lora_adapter) on each engine that should serve "
                    "this tenant")
        if not cands:
            return None, 0, False
        if self.config.policy == "round_robin":
            with self._lock:
                i = self._rr
                self._rr += 1
            return cands[i % len(cands)], 0, False
        # cold-start affinity: requests whose prefix NOBODY has cached yet
        # still deterministically prefer one replica (hash of the first
        # token block), so a burst sharing a brand-new prefix warms ONE
        # tree instead of paying the prefill once per replica while the
        # index is still cold. One block's worth of score — never enough
        # to override a real cached match or a serious load gap.
        bs = self.index.block_size
        aff = cands[hash(tuple(int(t) for t in prompt[:bs])) % len(cands)]
        # adapter-residency bonus: a replica that already holds the tenant's
        # pages on device admits without a host->device fault-in — worth a
        # cached block, same scale as cold-start affinity (enough to break
        # ties toward tenant stickiness, never enough to override a real
        # prefix match or a serious load gap)
        scored = [(matches.get(r.name, 0)
                   + (bs if r is aff else 0)
                   + (bs if adapter is not None
                      and self._adapter_state(r, adapter) == 2 else 0)
                   - self.config.balance * self._load(r),
                   matches.get(r.name, 0), r) for r in cands]
        pool = scored
        if self.config.federation:
            cold = [s for s in scored
                    if not self._hot(s[2], cls, len(prompt))]
            if not cold:
                return None, 0, False
            pool = cold
        best = max(pool, key=lambda s: s[0])
        cache_best = max(scored, key=lambda s: s[1])
        rebalanced = cache_best[1] > 0 and best[2] is not cache_best[2]
        return best[2], best[1], rebalanced

    def _pick_decode(self, exclude: Sequence[str] = ()) -> Replica:
        """Least-loaded routable decode replica — the handoff destination
        (called by PrefillWorker threads; ``exclude`` carries targets a
        retry already saw fail). Raises :class:`LookupError` when no decode
        replica can take the handoff."""
        cands = [r for r in self._decode
                 if r.name not in exclude and self._routable(r)]
        if not cands:
            raise LookupError(
                "no routable decode replica"
                + (f" (excluded: {list(exclude)})" if exclude else ""))
        return min(cands, key=lambda r: r.frontend._inflight)

    # ------------------------------------------------------------------ #
    # disaggregated path
    # ------------------------------------------------------------------ #

    def _submit_disaggregated(self, target: Replica, prompt, cls,
                              max_new_tokens: int, eos_token_id,
                              arrival_t: float) -> RequestHandle:
        # the budget math ServingFrontend.submit runs — ONE home
        # (check_budget), evaluated against the WEAKEST decode replica:
        # _pick_decode may land the handoff on ANY of them, so a request
        # only enters if every destination could hold its full KV lifetime
        self._decode[0].frontend.check_budget(
            len(prompt), max_new_tokens,
            max_context=min(r.engine.config.state_manager.max_context
                            for r in self._decode),
            total_blocks=min(r.engine.allocator.total_blocks
                             for r in self._decode))
        pre_sm = target.engine.config.state_manager
        if len(prompt) > pre_sm.max_context:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds prefill replica "
                f"{target.name!r} max_context {pre_sm.max_context}")
        bs = target.engine.kv.config.block_size
        if -(-len(prompt) // bs) > target.engine.allocator.total_blocks:
            raise ValueError(
                f"prompt needs {-(-len(prompt) // bs)} KV blocks but the "
                f"prefill pool holds {target.engine.allocator.total_blocks}")
        req = RequestHandle(next(self._uids), prompt, cls, max_new_tokens,
                            eos_token_id, arrival_t)
        if not getattr(self._serving_cfg, "attribution", True):
            req._ledger = None
        req._router_counted = True     # in _inflight until handoff or final
        with self._lock:
            self._inflight += 1
        try:
            self._workers[target.name].submit(req)
        except RuntimeError:           # worker fenced in the race window:
            req._router_counted = False   # undo the accounting and let the
            with self._lock:              # caller re-route
                self._inflight -= 1
            raise
        return req

    # -- PrefillWorker callbacks ---------------------------------------- #

    def _note_prefill(self, replica: Replica, tokens: int,
                      secs: float) -> None:
        self._prefill_cost[replica.name].update_prefill(tokens, secs)

    def _note_handoff(self, src: Replica, dst: Replica, req,
                      nbytes: int, t0: float) -> None:
        with self._lock:
            if getattr(req, "_router_counted", False):
                req._router_counted = False
                self._inflight -= 1
            self.stats.handoffs += 1
            self.stats.handoff_bytes += nbytes
        if _tracer.enabled:
            _tracer.add("serve/router/handoff", t0, time.perf_counter(),
                        lane="serve/router", uid=req.uid,
                        trace_id=req.trace_id, src=src.name,
                        dst=dst.name, bytes=nbytes)

    def _finalize_external(self, req: RequestHandle, status: str) -> None:
        """Terminal-state a handle the router (or a prefill worker) still
        owns: close the stream and release waiters — the RequestHandle
        contract, preserved outside any frontend. A handle counted in the
        router's in-flight gauge (disaggregated submissions awaiting
        handoff) leaves it here whatever the terminal status."""
        req.status = status
        req._q.put(_DONE)
        req._finished.set()
        if getattr(req, "_router_counted", False):
            req._router_counted = False
            with self._lock:
                self._inflight -= 1
