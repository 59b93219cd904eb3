"""Dynamic SplitFuse pass scheduler (host logic, as in the JAX package).

Long prompts are decomposed into chunks processed across passes; short work
is composed so every pass runs near the token budget. Each pass = all ready
decode tokens (one per active sequence, up to ``max_ragged_sequence_count``)
+ up to ``num_chunk_slots`` prompt chunks of ``chunk_slot_size`` tokens each.
Attention splits per section in ``ragged_model.py``: the paged chunk kernel
for the slots, the paged decode kernel for the rest, or the packed prefill
kernel when the whole pass prefills from position 0.

Sliding-window models (``window``, set by the engine from the model spec)
keep each sequence's KV in a PAGE RING, copied from the JAX package:
logical page i beyond ``ring_pages`` reuses ``blocks[i - ring_pages]``, so
the logical block list repeats physical ids (each freed once) and a
sequence's footprint is bounded by the window however long it runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache
from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import DecodeBatch, RaggedBatch
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor
from deepspeed_tpu_torch.utils.caching import next_pow2


class DynamicSplitFuseScheduler:

    def __init__(self, config: DSStateManagerConfig, cache: BlockedKVCache,
                 allocator: BlockedAllocator):
        self.config = config
        self.cache = cache
        self.allocator = allocator
        self.seqs: Dict[int, DSSequenceDescriptor] = {}
        bs = cache.config.block_size
        self.max_blocks = -(-config.max_context // bs)
        # sliding-window span (set by the engine from the model spec); with
        # a window, per-sequence physical KV is a page ring of ring_pages
        # blocks: dead tokens are overwritten in place
        self.window: Optional[int] = None

    @property
    def _pass_take_cap(self) -> int:
        """Max prompt tokens one sequence may take in one pass under a
        window (also bounds the live span the ring must cover)."""
        cfg = self.config
        return min(self.window + self.cache.config.block_size,
                   cfg.num_chunk_slots * cfg.chunk_slot_size)

    @property
    def ring_pages(self) -> Optional[int]:
        """Physical pages per sequence under a window. The live span during
        a pass is [earliest_query - window + 1, write_head]: a chunked
        continuation pass of T tokens still needs ``window`` tokens behind
        its FIRST query row while writing T ahead, so the ring covers
        window + T (+1 page of slack). Aliased logical pages are then >=
        ring*bs > window + T tokens apart: no pass reads or overwrites a
        page it still needs."""
        if self.window is None:
            return None
        bs = self.cache.config.block_size
        return -(-(self.window + self._pass_take_cap) // bs) + 1

    def ring_covers(self, n_tokens: int) -> bool:
        """True iff a consumer may freeze page reads while writing
        ``n_tokens`` ahead (the side-buffer decode schedule): the ring spans
        window + _pass_take_cap live tokens. Without a window there is no
        ring: always True."""
        if self.window is None:
            return True
        return n_tokens <= self._pass_take_cap

    # ------------------------------------------------------------------ #
    # sequence admission
    # ------------------------------------------------------------------ #

    def add_tokens(self, uid: int, tokens: np.ndarray) -> None:
        tokens = np.asarray(tokens, np.int32)
        seq = self.seqs.get(uid)
        known = 0 if seq is None else seq.seen_tokens + len(seq.pending)
        total = known + len(tokens)
        if total > self.config.max_context:
            raise ValueError(f"sequence {uid}: {total} tokens > max_context "
                             f"{self.config.max_context}")
        if seq is None:
            if len(self.seqs) >= self.config.max_tracked_sequences:
                raise RuntimeError(
                    f"max_tracked_sequences={self.config.max_tracked_sequences} exceeded")
            seq = self.seqs[uid] = DSSequenceDescriptor(uid=uid)
        seq.extend_pending(tokens)

    def flush(self, uid: int) -> None:
        """Release a sequence's KV blocks (ring reuse repeats physical ids in
        the logical list: each is freed once)."""
        seq = self.seqs.pop(uid, None)
        if seq is None or not seq.blocks:
            return
        self.allocator.free(list(dict.fromkeys(seq.blocks)))

    # ------------------------------------------------------------------ #
    # capacity queries
    # ------------------------------------------------------------------ #

    def _new_blocks_needed(self, seq: DSSequenceDescriptor, new_tokens: int) -> int:
        """Fresh allocator blocks required for ``new_tokens`` more tokens;
        under a window, capped by the ring (pages beyond it are reuses)."""
        need = seq.kv_blocks_needed(new_tokens, self.cache.config.block_size)
        ring = self.ring_pages
        if ring is not None:
            need = min(need, max(0, ring - len(seq.blocks)))
        return need

    def query(self, uid: int, max_request_tokens: int) -> Tuple[int, int]:
        """(max new tokens fundable by free blocks, available blocks).
        Accounts for queued-but-unprocessed pending tokens."""
        seq = self.seqs.get(uid, DSSequenceDescriptor(uid=uid))
        bs = self.cache.config.block_size
        avail = self.allocator.free_blocks
        if self.ring_pages is not None and len(seq.blocks) >= self.ring_pages:
            # ring complete: any request fits in place (up to max_context)
            return max_request_tokens, avail
        slack = len(seq.blocks) * bs - seq.seen_tokens - len(seq.pending)
        fundable = max(0, slack + avail * bs)
        return min(max_request_tokens, fundable), avail

    def can_schedule(self, uids: List[int], lengths: List[int]) -> bool:
        needed = 0
        for uid, n in zip(uids, lengths):
            seq = self.seqs.get(uid, DSSequenceDescriptor(uid=uid))
            needed += self._new_blocks_needed(seq, len(seq.pending) + n)
        if needed > self.allocator.free_blocks:
            return False
        new = sum(1 for u in uids if u not in self.seqs)
        return len(self.seqs) + new <= self.config.max_tracked_sequences

    def has_pending(self) -> bool:
        return any(len(s.pending) > 0 for s in self.seqs.values())

    # ------------------------------------------------------------------ #
    # pipelined decode support
    # ------------------------------------------------------------------ #

    def reserve(self, uid: int, n_tokens: int) -> None:
        """Pre-allocate KV blocks so ``uid`` can append ``n_tokens`` without
        host intervention. Enforces the same max_context bound as
        ``add_tokens``."""
        seq = self.seqs[uid]
        total = seq.seen_tokens + len(seq.pending) + n_tokens
        if total > self.config.max_context:
            raise ValueError(f"sequence {uid}: {total} tokens > max_context "
                             f"{self.config.max_context}")
        self._ensure_blocks(seq, n_tokens)

    def decode_batch(self, uids: List[int], n_reserve: int,
                     scratch_block: int) -> DecodeBatch:
        """Bucketed decode-only descriptors for the pipelined decode step.

        Reserves ``n_reserve`` tokens of KV per sequence UP FRONT (so the
        per-step host work during a pipelined run is just the
        ``DecodeBatch.advance`` increments), then packs positions, block
        tables and context lengths into arrays padded to
        ``next_pow2(len(uids))`` rows. Pad rows point wholly at
        ``scratch_block``."""
        for u in uids:
            self.reserve(u, n_reserve)
        bucket = next_pow2(len(uids))
        mb = self.max_blocks
        bt = np.full((bucket, mb), scratch_block, np.int32)
        pos = np.zeros((bucket,), np.int32)
        for i, u in enumerate(uids):
            seq = self.seqs[u]
            bt[i] = seq.block_table(mb)
            pos[i] = seq.seen_tokens
        return DecodeBatch(uids=[int(u) for u in uids], bucket=bucket,
                           positions=pos, block_tables=bt)

    def adopt_sequence(self, uid: int, tokens: np.ndarray,
                       n_blocks: int) -> List[int]:
        """Create a sequence whose KV was computed elsewhere (the import half
        of a page handoff, ``engine.import_kv``): allocate ``n_blocks`` fresh
        pages in logical order and mark all ``tokens`` as seen; the caller
        scatters the page content in (``engine.put_pages``) before the
        sequence decodes. Returns the allocated ids. JAX's checks, in its
        words."""
        if self.window is not None:
            raise NotImplementedError(
                "cross-engine KV adoption with a sliding-window page ring "
                "is not wired (the logical block list aliases physical "
                "pages)")
        tokens = np.asarray(tokens, np.int32)
        if uid in self.seqs:
            raise ValueError(f"sequence {uid} is already tracked")
        if len(tokens) < 1:
            raise ValueError("adopt_sequence needs at least one token")
        if len(tokens) > self.config.max_context:
            raise ValueError(f"sequence {uid}: {len(tokens)} tokens > "
                             f"max_context {self.config.max_context}")
        bs = self.cache.config.block_size
        if n_blocks * bs < len(tokens):
            raise ValueError(
                f"{n_blocks} pages cannot hold {len(tokens)} tokens at "
                f"block_size {bs}")
        if len(self.seqs) >= self.config.max_tracked_sequences:
            raise RuntimeError(
                f"max_tracked_sequences={self.config.max_tracked_sequences} "
                "exceeded")
        if n_blocks > self.allocator.free_blocks:
            raise RuntimeError(
                f"cannot adopt sequence {uid}: needs {n_blocks} KV blocks, "
                f"{self.allocator.free_blocks} obtainable")
        seq = self.seqs[uid] = DSSequenceDescriptor(uid=uid)
        ids = [int(b) for b in self.allocator.allocate(n_blocks)] if n_blocks else []
        seq.blocks.extend(ids)
        seq.seen_tokens = len(tokens)
        return ids

    def advance(self, uid: int, n_tokens: int) -> None:
        """Record ``n_tokens`` device-generated tokens (their KV was written
        by the decode step; no pending compute remains)."""
        seq = self.seqs[uid]
        if len(seq.pending):
            raise RuntimeError(f"advance() of sequence {uid} with pending "
                               "host tokens")
        seq.seen_tokens += n_tokens

    # ------------------------------------------------------------------ #
    # pass construction
    # ------------------------------------------------------------------ #

    def _ensure_blocks(self, seq: DSSequenceDescriptor, new_tokens: int) -> None:
        bs = self.cache.config.block_size
        ring = self.ring_pages
        if ring is None:
            need = seq.kv_blocks_needed(new_tokens, bs)
            if need:
                seq.blocks.extend(int(b) for b in self.allocator.allocate(need))
            return
        target = -(-(seq.seen_tokens + new_tokens) // bs)   # logical pages
        fresh = min(max(0, target - len(seq.blocks)),
                    max(0, ring - len(seq.blocks)))
        if fresh:
            seq.blocks.extend(int(b) for b in self.allocator.allocate(fresh))
        while len(seq.blocks) < target:                      # ring reuse
            seq.blocks.append(seq.blocks[len(seq.blocks) - ring])

    def schedule_pass(self) -> Optional[RaggedBatch]:
        """Build the next pass, or None when no pending work exists."""
        cfg = self.config
        NC, Cs = cfg.num_chunk_slots, cfg.chunk_slot_size
        S, MB = cfg.max_ragged_sequence_count, self.max_blocks
        bs = self.cache.config.block_size
        batch = RaggedBatch(num_slots=NC, slot_size=Cs, max_sequences=S,
                            max_blocks=MB)
        kv_dest = np.full((NC * Cs + S,), self.cache.oob_sentinel, np.int32)

        # decode rows: sequences holding exactly one pending token
        decode = [s for s in self.seqs.values()
                  if len(s.pending) == 1 and s.seen_tokens > 0]
        decode = decode[:S]
        for row, seq in enumerate(decode):
            self._ensure_blocks(seq, 1)
            pos = seq.seen_tokens
            batch.decode_uids.append(seq.uid)
            batch.decode_tokens[row] = seq.pending[0]
            batch.decode_positions[row] = pos
            batch.decode_block_tables[row] = seq.block_table(MB)
            batch.decode_ctx_lens[row] = pos + 1
            kv_dest[NC * Cs + row] = self.cache.flat_write_index(
                seq.blocks[pos // bs], pos % bs)
            seq.in_flight_tokens = 1

        # prompt chunks, up to NC slots: longest pending first. A sequence
        # may claim SEVERAL consecutive slots in one pass (its chunk KV is
        # written before attention runs, so a later slot sees the earlier
        # slots' tokens).
        prompts = sorted((s for s in self.seqs.values()
                          if len(s.pending) > 1 or
                          (len(s.pending) == 1 and s.seen_tokens == 0
                           and s.uid not in batch.decode_uids)),
                         key=lambda s: -len(s.pending))
        sl = 0
        from_zero = True   # every chunk sequence starts at position 0?
        # page-granular write plan (pure-prefill fast path; see RaggedBatch)
        PW = NC * Cs // bs + NC
        batch.page_ids = np.full((PW,), self.cache.config.num_blocks, np.int32)
        batch.page_rows = np.zeros((PW,), np.int32)
        batch.page_fill = np.zeros((PW,), np.int32)
        pw = 0
        for seq in prompts:
            if sl >= NC:
                break
            take = min(len(seq.pending), (NC - sl) * Cs)
            if self.window is not None:
                # the ring covers window + _pass_take_cap tokens of live
                # span; taking more in one pass would overwrite pages the
                # pass's own queries still need (the rest prefills next pass)
                take = min(take, self._pass_take_cap)
            self._ensure_blocks(seq, take)
            blocks = np.asarray(seq.blocks, np.int32)
            batch.chunk_uids.append(seq.uid)
            batch.chunk_is_final.append(take == len(seq.pending))
            if seq.seen_tokens > 0:
                from_zero = False
            else:
                # from position 0, tokens fill pages in order: one plan entry
                # per touched page, rows contiguous from this seq's first row.
                # Under a window, pages wholly dead by the end of the take are
                # skipped: their tokens are never attended again, and writing
                # them could collide with a ring-reused live page
                r0_seq = sl * Cs
                for p in range(-(-take // bs)):
                    if (self.window is not None
                            and (p + 1) * bs <= take - self.window):
                        continue
                    batch.page_ids[pw] = blocks[p]
                    batch.page_rows[pw] = r0_seq + p * bs
                    batch.page_fill[pw] = min(bs, take - p * bs)
                    pw += 1
            taken = 0
            while taken < take:
                n = min(Cs, take - taken)
                q0 = seq.seen_tokens + taken
                positions = q0 + np.arange(n, dtype=np.int32)
                r0 = sl * Cs
                batch.chunk_tokens[r0:r0 + n] = seq.pending[taken:taken + n]
                batch.chunk_positions[r0:r0 + n] = positions
                batch.chunk_ntok[sl] = n
                batch.chunk_block_tables[sl] = seq.block_table(MB)
                batch.chunk_q0[sl] = q0
                batch.chunk_ctx_lens[sl] = q0 + n
                batch.row_seg[r0:r0 + n] = len(batch.chunk_uids) - 1
                kv_dest[r0:r0 + n] = self.cache.flat_write_index(
                    blocks[positions // bs], positions % bs)
                batch.slot_uid.append(seq.uid)
                taken += n
                sl += 1
            seq.in_flight_tokens = take

        batch.kv_dest = kv_dest
        batch.kv_sentinel = self.cache.oob_sentinel
        batch.pure_prefill = (not batch.decode_uids and bool(batch.chunk_uids)
                              and from_zero)
        if batch.current_sequences == 0:
            return None
        # the packed prefill kernel's correctness contract (per-sequence rows
        # contiguous and in position order, padding rows seg -1) is PRODUCED
        # here, so it is checked here
        live = batch.row_seg >= 0
        segs = batch.row_seg[live]
        if segs.size > 1:
            dseg = np.diff(segs)
            dpos = np.diff(batch.chunk_positions[live])
            if not (np.all(dseg >= 0) and np.all(dpos[dseg == 0] == 1)):
                raise AssertionError(
                    "scheduler produced an interleaved/unordered packed "
                    "batch; flash_attention_packed requires per-sequence "
                    "rows contiguous and position-ordered")
        return batch

    def complete_pass(self, batch: RaggedBatch) -> List[int]:
        """Advance descriptors after the pass ran; returns uids whose
        next-token logits this pass produced (final prompt chunks + all
        decode rows)."""
        finished: List[int] = []
        for uid, is_final in zip(batch.chunk_uids, batch.chunk_is_final):
            seq = self.seqs[uid]
            n = seq.in_flight_tokens
            seq.seen_tokens += n
            seq.pending = seq.pending[n:]
            seq.in_flight_tokens = 0
            if is_final:
                finished.append(uid)
        for uid in batch.decode_uids:
            seq = self.seqs[uid]
            seq.seen_tokens += 1
            seq.pending = seq.pending[1:]
            seq.in_flight_tokens = 0
            finished.append(uid)
        return finished
