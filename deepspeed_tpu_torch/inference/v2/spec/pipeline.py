"""Speculative decode pipeline: draft, verify in one ragged forward, accept
(the JAX package's ``inference/v2/spec/pipeline.py``).

``SpecDecodePipeline`` is the ``DecodePipeline`` analog for speculation:
the same admit/retire/run surface over a fixed live set and the same
bucketed descriptors, but each step advances every row by a VARIABLE
count, the accepted draft prefix plus one greedy bonus token:

    host:   draft (n-gram match over each row's history) -> upload [S, k]
    device: ONE ragged forward scores all k + 1 rows of each sequence,
            writes their KV and computes the greedy accept mask and the
            bonus token (``ragged_model.build_verify_step``)
    host:   drain ONE int32 [2, S] row (accept counts, bonus tokens)
            through the pipeline's pinned buffer and event, rebuild the
            emitted tokens from the draft it proposed, draft the next step

The drain waits every step: the next draft must extend the tokens this
step emitted, which the host cannot know a step early. It is the same
policed device-to-host copy as the plain pipeline's (``pipeline._RowDrain``),
and the positions advance on the device by the drained counts' source, so
nothing else crosses.

Greedy speculation emits the tokens the plain pipeline would, as far as the
verify step's logits equal the decode step's: they agree to rounding on
the card (the chunk kernel against the decode kernel) and to f32 rounding
on the CPU, so two streams can part only where two logits nearly tie.
Rejected rows' KV stays past the advanced context inside pages the
sequence owns, never read; at the run's end ``scheduler.rollback_reserved``
frees the reserved pages the run never reached, so reject-heavy runs
return the pool to its baseline.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.pipeline import _RowDrain
from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
from deepspeed_tpu_torch.inference.v2.spec.proposer import DraftProposer, NGramProposer
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer


class _TokenBuf:
    """int32 token history in a doubling buffer: appends are element stores
    and the proposer reads a view (a list re-converted every step would
    copy O(T) a step, O(T^2) over a generation)."""

    __slots__ = ("a", "n")

    def __init__(self, toks):
        t = np.asarray(toks, np.int32).reshape(-1)
        self.a = np.empty((max(64, 2 * len(t)),), np.int32)
        self.a[:len(t)] = t
        self.n = len(t)

    def _grow(self, need: int) -> None:
        if self.n + need > len(self.a):
            a = np.empty((max(2 * len(self.a), self.n + need),), np.int32)
            a[:self.n] = self.a[:self.n]
            self.a = a

    def append(self, t: int) -> None:
        self._grow(1)
        self.a[self.n] = t
        self.n += 1

    def extend(self, toks) -> None:
        t = np.asarray(toks, np.int32).reshape(-1)
        self._grow(len(t))
        self.a[self.n:self.n + len(t)] = t
        self.n += len(t)

    def pop(self) -> None:
        self.n -= 1

    def view(self) -> np.ndarray:
        return self.a[:self.n]


class SpecDecodePipeline:
    """Draft-and-verify decode over a fixed live set of sequences, driven
    like ``DecodePipeline`` (``engine.decode_pipeline`` returns it when
    ``config.spec_decode.enabled`` and the request is greedy)::

        pipe = engine.decode_pipeline(uids)      # SpecDecodePipeline
        toks = pipe.run(16)      # per-row token lists (ragged: each step
                                 # emits 1..k+1 tokens a row)
        pipe.retire(done); engine.flush(done); pipe.admit(new)

    ``spec`` is True (callers branch their ``on_tokens`` shape on it).
    Sampling is not supported here: the engine routes sampled pipelines to
    the plain ``DecodePipeline`` with a one-time warning."""

    spec = True

    def __init__(self, engine, uids: Sequence[int],
                 proposer: Optional[DraftProposer] = None):
        self.engine = engine
        cfg = engine.config.spec_decode
        self.k = int(cfg.k)
        self.adaptive = bool(cfg.adaptive)
        self.proposer = proposer if proposer is not None else NGramProposer(
            min_match=cfg.min_match, max_ngram=cfg.max_ngram)
        self.uids: List[int] = []
        self.stats = engine.spec_stats
        # per uid: the token history the proposer matches over (prompt +
        # emitted) and the adaptive draft budget
        self._hist: Dict[int, _TokenBuf] = {}
        self._k_eff: Dict[int, int] = {}
        self.admit(uids)

    # ------------------------------------------------------------------ #
    # live-set management (between runs)
    # ------------------------------------------------------------------ #

    def retire(self, uids: Iterable[int]) -> None:
        """Drop sequences from the live set (flush them to release KV);
        their draft history goes with them."""
        gone = {int(u) for u in uids}
        self.uids = [u for u in self.uids if u not in gone]
        for u in gone:
            self._hist.pop(u, None)
            self._k_eff.pop(u, None)

    def admit(self, uids: Iterable[int],
              histories: Optional[Sequence[Sequence[int]]] = None) -> None:
        """Add prefilled sequences (after ``engine.put``). ``histories``
        optionally seeds each row's draft history; by default the
        scheduler's recorded history is used (the engine records it when
        spec decode is on), so drafts can match into the prompt from the
        first step."""
        e = self.engine
        uids = [int(u) for u in uids]
        if histories is not None and len(histories) != len(uids):
            raise ValueError("histories must align with uids")
        for i, u in enumerate(uids):
            seq = e.scheduler.seqs.get(u)
            if seq is None or len(seq.pending):
                raise ValueError(f"uid {u} is not in steady decode state")
            if u not in e._last_ref and u not in e._last_logits:
                raise ValueError(f"uid {u} has no last-logits state to "
                                 "sample from (run put() first)")
            if u in self.uids:
                raise ValueError(f"uid {u} already in the pipeline")
            self.uids.append(u)
            self._hist[u] = _TokenBuf(histories[i] if histories is not None
                                      else seq.history())
            self._k_eff[u] = self.k

    # ------------------------------------------------------------------ #
    # the hot loop
    # ------------------------------------------------------------------ #

    def _tune_k(self, u: int, proposed: int, accepted: int) -> None:
        """Per-sequence adaptive draft budget: a full accept doubles it (up
        to k), any reject drops it to accepted + 1 (a probe of 1 stays, so a
        row re-entering a repetitive span is found again)."""
        if not self.adaptive or proposed < 1:
            return
        if accepted >= proposed:
            self._k_eff[u] = min(self.k, max(2 * self._k_eff[u], 1))
        else:
            self._k_eff[u] = max(1, accepted + 1)

    def run(self, n_steps: int,
            on_tokens: Optional[Callable] = None) -> List[List[int]]:
        """Run ``n_steps`` verify steps; returns each live row's emitted
        tokens (between ``n_steps`` and ``n_steps * (k + 1)`` a row) in
        ``self.uids`` order at run start.

        ``on_tokens(step, uids, toks)`` is called after each step's drain
        with ``toks`` a list of int32 arrays, row i's tokens emitted THIS
        step. Its truthy return value is an iterable of uids to retire:
        recording and drafting for them stop, their continuation refs drop
        and they leave the live set, while their device rows run to the
        end of the run (the ``DecodePipeline`` trade). If the callback
        raises, state settles first (histories advanced to the drained
        spans, reserved pages rolled back, refs dropped, every uid leaves
        the pipeline: flush or re-``put`` before reuse)."""
        e = self.engine
        uids = list(self.uids)
        S = len(uids)
        if S == 0 or n_steps <= 0:
            return [[] for _ in range(S)]
        if e.scheduler.has_pending():
            raise RuntimeError("spec decode pipeline requires a drained scheduler")
        perf = time.perf_counter
        K1 = self.k + 1
        # reserve for FULL acceptance up front (a verify step writes up to
        # k + 1 positions ahead with no host step); the run's end rolls back
        # what rejection left unused
        db = e.scheduler.decode_batch(uids, n_steps * K1 + 1, e.scratch_block)
        # each step runs the SMALLEST rung of the ladder covering its
        # longest draft; a step with no draft anywhere runs the plain
        # decode step
        ladder = e.spec_k_ladder
        # run-invariant LoRA operands, as block_tables (none at rank bucket
        # 0): the same [bucket, rb] page table feeds the verify and the
        # plain step, a sequence's k + 1 verify rows sharing its pages
        rb = e.lora_rank_bucket
        lora = e._lora_operands(uids, db.bucket, rb)
        block_tables = to_device(db.block_tables, e.device)
        pos = to_device(db.positions, e.device)
        ids = e._sample_device_padded(uids, False, 1.0, 0)
        # the run's one extra drain, the bootstrap row: step j emits the
        # committed tokens (the carry: step j-1's bonus, this row at step 0)
        # plus its accepted drafts; its bonus is step j+1's carry, and the
        # last bonus stays unemitted, re-derived from the final logits
        boot = _RowDrain(db.bucket, e.device)
        boot.start(0, ids)
        carry = boot.wait(0)
        drain = _RowDrain(2 * db.bucket, e.device)

        outs: List[List[int]] = [[] for _ in range(S)]
        live = np.ones((S,), bool)
        emitted = np.zeros((S,), np.int64)     # tokens each device row wrote
        recorded = np.zeros((S,), np.int64)    # of them, drained while live
        row_of = {u: i for i, u in enumerate(uids)}
        final_logits = None
        for i, u in enumerate(uids):
            self._hist[u].append(int(carry[i]))
        try:
            for j in range(n_steps):
                t0 = perf()
                draft, n_draft = self._draft_step(uids, live, db.bucket)
                t1 = perf()
                kmax = int(n_draft.max())
                if kmax > 0:
                    k_step = next(k_ for k_ in ladder if k_ >= kmax)
                    accept_row, nxt, final_logits = e._verify_fn(k_step, rb)(
                        e.weights, e.kv.kv, ids, to_device(draft[:, :k_step], e.device),
                        to_device(n_draft, e.device), pos, block_tables, pos + 1,
                        kv_scales=e.kv.scales, **lora)
                else:
                    # nothing to verify anywhere: one plain greedy decode step
                    nxt, final_logits = e._decode_step_fn(rb)(
                        e.weights, e.kv.kv, ids, pos, block_tables, pos + 1,
                        e.generator, False, 0, 1.0, kv_scales=e.kv.scales, **lora)
                    accept_row = torch.stack([torch.zeros_like(nxt), nxt])
                drain.start(0, accept_row.reshape(-1))
                t2 = perf()
                # the ONE per-step drain: accept counts and bonus tokens
                row = drain.wait(0).reshape(2, db.bucket)
                t3 = perf()
                step_tokens = proposed = accepted = 0
                toks: List[np.ndarray] = [np.zeros((0,), np.int32)] * S
                for i, u in enumerate(uids):
                    a = int(row[0, i])
                    emitted[i] += a + 1
                    if not live[i]:
                        continue
                    # this step's stream tokens: the carry, committed by row
                    # 0, and the accepted drafts; the bonus row[1, i] is the
                    # next carry (in the draft history, not yet in the stream)
                    tk = np.concatenate([carry[i:i + 1], draft[i, :a]]).astype(np.int32)
                    toks[i] = tk
                    self._hist[u].extend(draft[i, :a])
                    self._hist[u].append(int(row[1, i]))
                    outs[i].extend(int(t) for t in tk)
                    recorded[i] = emitted[i]
                    step_tokens += a + 1
                    proposed += int(n_draft[i])
                    accepted += a
                    self._tune_k(u, int(n_draft[i]), a)
                carry = row[1]
                tc = tc2 = t3
                if on_tokens is not None:
                    tc = perf()
                    stop = on_tokens(j, uids, toks)
                    tc2 = perf()
                    for u in stop or ():
                        i = row_of.get(int(u))
                        if i is not None and live[i]:
                            live[i] = False
                            self._hist.pop(int(u), None)
                            self._k_eff.pop(int(u), None)
                # device rows advance by what the device wrote, retired rows
                # and pad rows (always 1: no draft) included
                pos = pos + accept_row[0] + 1
                ids = nxt
                t4 = perf()
                self.stats.record_step(
                    rows=int(live.sum()), proposed=proposed, accepted=accepted,
                    tokens=step_tokens, draft_s=t1 - t0, verify_s=t3 - t1,
                    fetch_bytes=row.nbytes)
                if _tracer.enabled:
                    _tracer.add("serve/spec/draft", t0, t1, lane="serve/spec", step=j)
                    _tracer.add("serve/spec/dispatch", t1, t2, lane="serve/spec", step=j)
                    _tracer.add("serve/spec/drain", t2, t3, lane="serve/spec", step=j)
                    if on_tokens is not None:
                        _tracer.add("serve/spec/callback", tc, tc2,
                                    lane="serve/spec", step=j)
                    _tracer.add("serve/spec/step", t0, t4, lane="serve/spec", step=j,
                                tokens=step_tokens, accepted=accepted)
        except BaseException:
            for i, u in enumerate(uids):
                e.scheduler.advance(u, int(recorded[i]))
                e.scheduler.rollback_reserved(u)
                e._last_ref.pop(u, None)
                e._last_logits.pop(u, None)
                self._hist.pop(u, None)
                self._k_eff.pop(u, None)
            self.uids = []
            raise
        for i, u in enumerate(uids):
            e._last_logits.pop(u, None)
            if live[i]:
                e.scheduler.advance(u, int(emitted[i]))
                e._last_ref[u] = (final_logits, i)
                # the trailing unemitted bonus leaves the draft history: the
                # next run re-derives it from the refs and appends it again
                self._hist[u].pop()
            else:
                # retired mid-run: only the recorded span becomes history;
                # the refs would point past it
                e.scheduler.advance(u, int(recorded[i]))
                e._last_ref.pop(u, None)
            # the reserved pages the run never reached return to the pool
            e.scheduler.rollback_reserved(u)
        self.uids = [u for i, u in enumerate(uids) if live[i]]
        return outs

    def _draft_step(self, uids: List[int], live: np.ndarray, bucket: int):
        """Drafts of the live rows (retired rows stop proposing: their device
        row decays to a plain one-token step)."""
        draft = np.zeros((bucket, self.k), np.int32)
        n_draft = np.zeros((bucket,), np.int32)
        for i, u in enumerate(uids):
            if not live[i]:
                continue
            budget = self._k_eff[u] if self.adaptive else self.k
            if budget < 1:
                continue
            d = self.proposer.propose(self._hist[u].view(), budget)
            if len(d):
                draft[i, :len(d)] = d
                n_draft[i] = len(d)
        return draft, n_draft
