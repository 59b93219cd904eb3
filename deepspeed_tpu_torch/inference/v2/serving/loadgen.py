"""Poisson load generator + goodput-under-SLO accounting (the JAX
package's ``serving/loadgen.py``, copied).

A serving stack is judged not by peak tokens/sec but by *goodput under
SLO* — completed tokens/sec counted
ONLY from requests that met their class's TTFT and TBT targets, at a request
rate that saturates the KV pool. A frontend that admits everything and blows
every deadline scores zero; so does one that sheds everything. This module
provides the open-loop workload (seeded, so every run of one seed replays
the identical arrival sequence) and the scoring.

Arrivals are Poisson (exponential inter-arrival gaps at ``rate``/s — the
standard open-loop serving-bench model; closed-loop clients hide queueing
delay exactly where SLOs live). Each arrival draws a mixture component
(priority class + prompt-length + generation-length choices) by weight, so
one stream carries the mixed multi-tenant traffic admission exists to
arbitrate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class WorkloadComponent:
    """One mixture component: requests of priority class ``cls`` arriving
    with probability ``weight`` (normalised over the mix), drawing prompt
    and generation lengths uniformly from the given choices.

    ``prefix_len > 0`` gives the component a SHARED PREFIX: one token block
    of that length is drawn per component (seed-keyed, before any arrival —
    see ``arrivals``) and prepended to every prompt the component emits,
    ``prompt_lens`` then sizing only the unique tail. This is the traffic
    shape cache-aware routing exists for (shared system prompts / few-shot
    templates).

    ``adapter_id`` names the LoRA adapter (tenant identity) the component's
    requests decode under: a string pins every arrival to that tenant; a
    sequence of names draws one per arrival (seed-keyed, uniform), a
    multi-tenant churn. ``None`` (the
    default) serves the base model AND consumes no randomness, the same
    pin discipline as ``prefix_len``: an adapter-free mix replays its
    pre-LoRA arrival stream byte-for-byte."""
    cls: str
    weight: float
    prompt_lens: Sequence[int]
    gen_lens: Sequence[int]
    prefix_len: int = 0
    adapter_id: object = None


@dataclass
class Arrival:
    t: float                      # seconds from stream start
    cls: str
    prompt: np.ndarray
    max_new_tokens: int
    adapter: Optional[str] = None   # LoRA adapter (tenant), None = base


class PoissonLoadGen:

    def __init__(self, rate: float, mix: Sequence[WorkloadComponent],
                 vocab: int, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.mix = [c if isinstance(c, WorkloadComponent)
                    else WorkloadComponent(**c) for c in mix]
        self.vocab = int(vocab)
        self.seed = int(seed)

    def arrivals(self, n: Optional[int] = None,
                 duration: Optional[float] = None) -> List[Arrival]:
        """The deterministic arrival schedule: ``n`` requests, or as many as
        land inside ``duration`` seconds (one of the two must be given).

        A pure function of ``(seed, rate, mix, vocab)`` — the per-request
        ``(class, prompt, arrival, max_new)`` stream is independent of what
        the arrivals are later scored against, so a router-vs-direct
        byte-equality gate replays the EXACT same workload on both sides
        (tests/unit/test_serving_router.py pins this). Shared prefixes are
        drawn first, in mix order, only for components that declare one —
        an all-``prefix_len=0`` mix therefore reproduces the pre-prefix
        stream for a given seed byte-for-byte."""
        if (n is None) == (duration is None):
            raise ValueError("pass exactly one of n / duration")
        rng = np.random.RandomState(self.seed)
        prefixes = [rng.randint(0, self.vocab,
                                size=(c.prefix_len,)).astype(np.int32)
                    if c.prefix_len > 0 else None for c in self.mix]
        w = np.asarray([c.weight for c in self.mix], np.float64)
        w = w / w.sum()
        out: List[Arrival] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / self.rate))
            if duration is not None and t > duration:
                break
            if n is not None and len(out) >= n:
                break
            ci = int(rng.choice(len(self.mix), p=w))
            comp = self.mix[ci]
            plen = int(comp.prompt_lens[int(rng.randint(len(comp.prompt_lens)))])
            glen = int(comp.gen_lens[int(rng.randint(len(comp.gen_lens)))])
            prompt = rng.randint(0, self.vocab, size=(plen,)).astype(np.int32)
            if prefixes[ci] is not None:
                prompt = np.concatenate([prefixes[ci], prompt])
            # tenant draw LAST, and only for components that declare
            # adapters (a fixed string consumes no randomness either) —
            # adapter-free mixes keep their exact pre-LoRA RNG stream
            ad = comp.adapter_id
            if ad is not None and not isinstance(ad, str):
                ad = str(ad[int(rng.randint(len(ad)))])
            out.append(Arrival(t=t, cls=comp.cls, prompt=prompt,
                               max_new_tokens=glen, adapter=ad))
        return out


def replay(frontend, arrivals: Sequence[Arrival], speed: float = 1.0) -> List:
    """Open-loop replay: submit each arrival at its scheduled wall-clock
    time (divided by ``speed``) against a RUNNING frontend — or anything
    with its ``submit`` signature, e.g. a ``ServingRouter`` — returning the
    request handles in arrival order. Late submissions (the loop fell
    behind) fire immediately — open-loop means the generator never waits
    for the server."""
    handles = []
    t0 = time.perf_counter()
    for a in arrivals:
        delay = a.t / speed - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        # adapter-free arrivals call the exact pre-LoRA signature: replay
        # targets only need submit(adapter=) when the mix names tenants
        kw = {} if a.adapter is None else {"adapter": a.adapter}
        handles.append(frontend.submit(a.prompt, priority=a.cls,
                                       max_new_tokens=a.max_new_tokens, **kw))
    return handles


def slo_met(handle) -> bool:
    """Did a FINISHED request meet its class SLOs? TTFT against
    ``ttft_slo_ms``; p95 of its token gaps against ``tbt_slo_ms`` (a single
    preemption blows the gap budget unless the restore was fast — exactly
    the pressure the bench compares preemption policies under)."""
    if handle.status != "finished" or handle.ttft_ms is None:
        return False
    if handle.ttft_ms > handle.cls.ttft_slo_ms:
        return False
    if handle.tbt_ms:
        p95 = float(np.percentile(np.asarray(handle.tbt_ms, np.float64), 95))
        if p95 > handle.cls.tbt_slo_ms:
            return False
    return True


def goodput_report(handles: Sequence, wall_s: float) -> Dict:
    """Score one replay: goodput (SLO-met completed tokens/s), raw
    throughput, and per-class completion/SLO/latency percentiles."""
    per_cls: Dict[str, Dict] = {}
    good_tokens = 0
    total_tokens = 0
    for h in handles:
        c = per_cls.setdefault(h.cls.name, {
            "submitted": 0, "finished": 0, "shed": 0, "cancelled": 0,
            "slo_met": 0, "tokens": 0, "ttft_ms": [], "tbt_ms": []})
        c["submitted"] += 1
        total_tokens += len(h.tokens)
        if h.status == "finished":
            c["finished"] += 1
            c["tokens"] += len(h.tokens)
            if h.ttft_ms is not None:
                c["ttft_ms"].append(h.ttft_ms)
            c["tbt_ms"].extend(h.tbt_ms)
            if slo_met(h):
                c["slo_met"] += 1
                good_tokens += len(h.tokens)
        elif h.status == "shed":
            c["shed"] += 1
        elif h.status == "cancelled":
            c["cancelled"] += 1

    def pct(xs, q):
        return round(float(np.percentile(np.asarray(xs, np.float64), q)), 2) \
            if xs else None

    classes = {}
    for name, c in per_cls.items():
        classes[name] = {
            "submitted": c["submitted"], "finished": c["finished"],
            "shed": c["shed"], "cancelled": c["cancelled"],
            "slo_met": c["slo_met"],
            "ttft_p50_ms": pct(c["ttft_ms"], 50),
            "ttft_p95_ms": pct(c["ttft_ms"], 95),
            "tbt_p50_ms": pct(c["tbt_ms"], 50),
            "tbt_p95_ms": pct(c["tbt_ms"], 95),
        }
    return {
        "wall_s": round(wall_s, 2),
        "goodput_tokens_per_sec": round(good_tokens / wall_s, 1),
        "total_tokens_per_sec": round(total_tokens / wall_s, 1),
        "good_tokens": good_tokens,
        "classes": classes,
    }
