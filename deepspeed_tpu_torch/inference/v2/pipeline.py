"""Double-buffered decode pipeline — the v2 steady-state serving loop.

    device:  [ step N-1 ]  [ step N ]  [ step N+1 ]
    host:          | launch N | drain N-1's row | build N+1 | launch N+1 |

- **Sampling is fused into the decode step** (``build_decode_step``): step
  N consumes step N-1's token row on the device; no host round trip sits
  between consecutive steps.
- **One int32 row per step crosses to the host**, drained ONE STEP LATE:
  right after launching step N (which samples token N+1), the host queues a
  ``non_blocking`` copy of token N+1's row into a pinned host buffer and
  records a CUDA event behind it; it then waits only for the event of token
  N's copy, queued one iteration earlier. Two pinned buffers alternate, and a
  buffer is refilled only after its previous row has been read out.
- **The split rung is picked every step** (``engine._attn_rung``): the
  step runs at the engine's rung for the current live context.
- **LoRA operands are fixed for the run**: with adapters registered the
  step is the engine's LoRA step at its rank bucket, and the pool and the
  rows' page table go to it unchanged every step (bindings cannot change
  while a request is in flight).
- **Descriptors are bucketed** (``DecodeBatch``) and KV blocks are
  pre-reserved for the whole run: block tables go to the device once per
  run, and step N+1's positions are the run's first positions plus N+1,
  computed on the device.

Each step takes five ``perf_counter`` stamps (launch, drain, build, the
callback, end) that feed both ``engine.pipeline_stats`` and, when tracing,
the ``serve/decode/{dispatch,drain,build,callback,step}`` spans, so the
counters and the timeline read one measurement.

Consequence of the late drain: the host observes token j while the device
computes token j+1, so a stop decision on token j lands after one extra
token of device work; ``on_tokens`` retirement stops *recording*, not the
device.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils import locksan as _locksan


class _RowDrain:
    """Device token rows -> host, through two alternating pinned buffers
    gated by events (plain synchronous copies on the CPU).

    ``wait`` is the serving engine's policed device-to-host drain (the JAX
    package's ``engine_v2.fetch_to_host``): under tracing it records a
    ``serve/drain/fetch_to_host`` span, and with the lock-order sanitizer
    armed it notes a blocking call made while sanitized locks are held."""

    def __init__(self, n: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(n, dtype=torch.int32, pin_memory=self.cuda)
                     for _ in range(2)]
        self.events = [torch.cuda.Event() if self.cuda else None
                       for _ in range(2)]

    def start(self, slot: int, row: torch.Tensor) -> None:
        self.bufs[slot].copy_(row, non_blocking=self.cuda)
        if self.cuda:
            self.events[slot].record()

    def wait(self, slot: int) -> np.ndarray:
        if _locksan.enabled():
            _locksan.note_blocking("fetch_to_host")
        if not _tracer.enabled:
            if self.cuda:
                self.events[slot].synchronize()
            return self.bufs[slot].numpy().copy()
        t0 = time.perf_counter()
        if self.cuda:
            self.events[slot].synchronize()
        row = self.bufs[slot].numpy().copy()
        _tracer.add("serve/drain/fetch_to_host", t0, time.perf_counter(),
                    lane="serve/drain")
        return row


class DecodePipeline:
    """Double-buffered decode over a fixed live set of sequences.

    All ``uids`` must be in steady decode state: known to the scheduler, no
    pending host tokens, last logits available (after ``put()`` or a
    previous run). Drive it as::

        pipe = engine.decode_pipeline(uids)
        tokens = pipe.run(64)            # [len(uids), 64], greedy
        pipe.retire(done_uids); engine.flush(done_uids)
        pipe.admit(new_uids)             # after engine.put() prefilled them
    """

    def __init__(self, engine, uids: Sequence[int], do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0):
        self.engine = engine
        self.uids: List[int] = []
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.admit(uids)

    def retire(self, uids: Iterable[int]) -> None:
        """Drop sequences from the live set (flush them to release KV)."""
        gone = {int(u) for u in uids}
        self.uids = [u for u in self.uids if u not in gone]

    def admit(self, uids: Iterable[int]) -> None:
        """Add prefilled sequences (after ``engine.put``) to the live set."""
        e = self.engine
        for u in uids:
            u = int(u)
            seq = e.scheduler.seqs.get(u)
            if seq is None or len(seq.pending):
                raise ValueError(f"uid {u} is not in steady decode state")
            if u not in e._last_ref and u not in e._last_logits:
                raise ValueError(f"uid {u} has no last-logits state to sample "
                                 "from (run put() first)")
            if u in self.uids:
                raise ValueError(f"uid {u} already in the pipeline")
            self.uids.append(u)

    def run(self, n_steps: int,
            on_tokens: Optional[Callable] = None) -> np.ndarray:
        """Generate ``n_steps`` tokens per live sequence; returns the ids
        [live, n_steps] in ``self.uids`` order at run start.

        ``on_tokens(step, uids, row)`` is called as each step's token row is
        drained (one step late). Its return value, if truthy, is an iterable
        of uids to retire: recording for them stops, their continuation refs
        are dropped, and they leave the live set. If the callback raises,
        every row's history is settled at its drained span and all uids
        leave the pipeline before the exception propagates."""
        e = self.engine
        uids = list(self.uids)
        S = len(uids)
        if S == 0 or n_steps <= 0:
            return np.zeros((S, 0), np.int32)
        if e.scheduler.has_pending():
            raise RuntimeError("decode pipeline requires a drained scheduler")
        db = e.scheduler.decode_batch(uids, n_steps + 1, e.scratch_block)
        # block tables are run-invariant (KV pre-reserved): upload ONCE
        block_tables = to_device(db.block_tables, e.device)
        positions0 = to_device(db.positions, e.device)
        # so are the LoRA operands (a bound adapter's refcount keeps its
        # pages in place); none at rank bucket 0, whose step is the base one
        rb = e.lora_rank_bucket
        lora = e._lora_operands(uids, db.bucket, rb)
        ids = e._sample_device_padded(uids, self.do_sample, self.temperature,
                                      self.top_k)
        drain = _RowDrain(db.bucket, e.device)
        drain.start(0, ids)

        out = np.empty((n_steps, S), np.int32)
        live = np.ones((S,), bool)
        recorded = np.full((S,), n_steps, np.int32)
        row_of = {u: i for i, u in enumerate(uids)}
        logits = None
        steps_drained = 0
        perf = time.perf_counter
        st = e.pipeline_stats
        del st.step_wall_ms[:]   # per-run latencies (cumulative fields stay)
        try:
            for j in range(n_steps):
                t0 = perf()
                # launch step j at this step's split rung: consumes the
                # device row `ids` (token j), writes its KV (and scales, for
                # an int8 pool), samples token j+1
                pos = positions0 + j
                nxt, logits = e._decode_step_fn(rb)(
                    e.weights, e.kv.kv, ids, pos, block_tables, pos + 1,
                    e.generator, self.do_sample, self.top_k, self.temperature,
                    kv_scales=e.kv.scales, **lora)
                drain.start((j + 1) % 2, nxt)
                t1 = perf()
                # drain token j's row (its copy was queued an iteration ago)
                row = drain.wait(j % 2)
                t2 = perf()
                out[j] = row[:S]
                steps_drained = j + 1
                # rows retired THIS step still had token j drained
                drained_tokens = int(live.sum())
                cb_s = 0.0
                tc = tc2 = t2
                if on_tokens is not None:
                    tc = perf()
                    stop = on_tokens(j, uids, out[j])
                    tc2 = perf()
                    cb_s = tc2 - tc      # callback cost -> bubble, not build
                    for u in stop or ():
                        i = row_of.get(int(u))
                        if i is not None and live[i]:
                            live[i] = False
                            recorded[i] = j + 1
                ids = nxt
                t3 = perf()
                st.record_step(dispatch_s=t1 - t0, drain_s=t2 - t1,
                               build_s=(t3 - t2) - cb_s, wall_s=t3 - t0,
                               fetch_bytes=row.nbytes, live_tokens=drained_tokens)
                if _tracer.enabled:
                    # the same stamps as the stats; the build span leaves
                    # out the callback window, which has a span of its own
                    _tracer.add("serve/decode/dispatch", t0, t1,
                                lane="serve/decode", step=j)
                    _tracer.add("serve/decode/drain", t1, t2,
                                lane="serve/decode", step=j)
                    if on_tokens is not None:
                        _tracer.add("serve/decode/build", t2, tc,
                                    lane="serve/decode", step=j)
                        _tracer.add("serve/decode/callback", tc, tc2,
                                    lane="serve/decode", step=j)
                        _tracer.add("serve/decode/build", tc2, t3,
                                    lane="serve/decode", step=j)
                    else:
                        _tracer.add("serve/decode/build", t2, t3,
                                    lane="serve/decode", step=j)
                    _tracer.add("serve/decode/step", t0, t3,
                                lane="serve/decode", step=j,
                                live=drained_tokens)
        except BaseException:
            for i, u in enumerate(uids):
                e.scheduler.advance(u, min(int(recorded[i]), steps_drained))
                e._last_ref.pop(u, None)
                e._last_logits.pop(u, None)
            self.uids = []
            raise
        # the final step's sampled row (token n_steps) stays on the device,
        # discarded; a continuation re-derives it from the final logits
        for i, u in enumerate(uids):
            e._last_logits.pop(u, None)
            if live[i]:
                e.scheduler.advance(u, n_steps)
                e._last_ref[u] = (logits, i)
            else:
                # mid-run retirement: only the recorded span becomes history
                e.scheduler.advance(u, int(recorded[i]))
                e._last_ref.pop(u, None)
        self.uids = [u for i, u in enumerate(uids) if live[i]]
        return out.T.copy()
