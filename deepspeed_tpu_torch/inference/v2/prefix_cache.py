"""Automatic prefix caching: radix-tree KV page reuse for the v2 engine,
copied from the JAX package's ``inference/v2/prefix_cache.py`` (host-only
logic; the one device step, the copy-on-write page copy, is the caller's
``cow_fn``: ``BlockedKVCache.copy_page``).

A host-side radix tree over TOKEN BLOCKS. Every node owns one KV page and
is keyed by the tuple of tokens that fill it, so a node's page is valid KV
iff a request's tokens match the whole root->node path. Full pages
(``block_size`` tokens) are shared directly: a match adds an allocator
reference and splices the page id into the new sequence's block table with
zero prefill scheduled. A *partial* leaf (a flushed prompt tail that never
filled its last page) is adopted copy-on-write: a fresh page is allocated,
the cached page is copied on the device (``cow_fn``, which over an int8
pool copies the page's scale tile too), and the adopter writes on into its
private copy.

Lifecycle:
  - ``insert`` (eager, at prefill completion, and again at flush) files a
    live sequence's pages into the tree, taking a tree-owned reference per
    adopted page. At flush the sequence's own references transfer or
    release, so completed sequences' pages stay cached (refcount 1).
  - ``match`` (at admission) walks the tree and hands back shared pages.
  - ``evict`` frees least-recently-used refcount-1 leaves when the pool runs
    dry or ``max_cached_blocks`` is exceeded; interior pages become
    evictable as their children go.

Every full-block node carries a root->path chain hash (``chain_hash``);
``add_listener`` feeds insert/evict deltas to a cluster-wide prefix index,
and ``match_len`` answers how much of a prompt is cached here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator

Event = Tuple[str, float, int]

#: chain hash of the (empty) root path — the seed every token-block chain
#: hash grows from. The multi-replica router's shared prefix index
#: (``serving/router.py ClusterPrefixIndex``) walks a request's blocks with
#: the SAME chain function, so index membership == radix-tree path existence.
ROOT_CHAIN = 0


def chain_hash(parent_chain: int, key: Tuple[int, ...]) -> int:
    """Chained token-block hash identifying one root->node path (stable
    within a process — the router and its replicas share one). A node's
    chain commits to every token block above it, so two trees holding the
    same chain hold the same cached token prefix (modulo hash collisions,
    which cost a mis-route, never correctness — routing is a placement
    hint; the replica's own ``match`` decides what actually attaches)."""
    return hash((parent_chain, key))


@dataclass
class PrefixCacheStats:
    """Counters surfaced through ``monitor/`` (``events()``) and the serving
    bench. ``tokens_saved`` counts prompt tokens whose prefill was skipped."""
    lookups: int = 0
    hits: int = 0                 # lookups that matched at least one block
    misses: int = 0
    matched_blocks: int = 0       # full pages spliced in across all lookups
    partial_hits: int = 0         # COW adoptions of a partial leaf
    tokens_saved: int = 0
    tokens_requested: int = 0
    insertions: int = 0           # nodes created
    evictions: int = 0            # pages LRU-freed back to the pool
    cow_copies: int = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of requested prompt tokens served from cache."""
        return self.tokens_saved / self.tokens_requested \
            if self.tokens_requested else 0.0

    def events(self, step: int = 0) -> List[Event]:
        """Monitor-ready ``(name, value, step)`` tuples (MonitorMaster
        ``write_events`` format)."""
        return [
            ("inference/prefix_cache/hit_rate", float(self.hit_rate), step),
            ("inference/prefix_cache/tokens_saved", float(self.tokens_saved), step),
            ("inference/prefix_cache/matched_blocks", float(self.matched_blocks), step),
            ("inference/prefix_cache/evictions", float(self.evictions), step),
            ("inference/prefix_cache/insertions", float(self.insertions), step),
            ("inference/prefix_cache/cow_copies", float(self.cow_copies), step),
        ]


class _RadixNode:
    __slots__ = ("key", "block_id", "parent", "children", "partials",
                 "last_access", "chain", "version")

    def __init__(self, key: Tuple[int, ...], block_id: Optional[int],
                 parent: Optional["_RadixNode"]):
        self.key = key                    # tokens backing this node's page
        self.block_id = block_id          # None only at the root
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _RadixNode] = {}   # full pages
        self.partials: Dict[Tuple[int, ...], _RadixNode] = {}   # partial leaves
        self.last_access = 0
        # root->node chain hash (chain_hash); None for partial leaves — only
        # full-block nodes are routable (the router delta feed skips partials)
        self.chain: Optional[int] = None
        # weight-version stamp (colocated rollout): the engine weights this
        # node's KV page was computed under. A node whose stamp trails the
        # tree's current version is stale-KV — match/match_len refuse it
        # even if a deferred flush left it in the tree.
        self.version = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


@dataclass
class PrefixMatch:
    """Result of ``match``: pages the sequence may attach (references already
    taken on its behalf) and how many prompt tokens they cover."""
    blocks: List[int] = field(default_factory=list)
    n_cached: int = 0             # tokens covered (prefill to skip)
    cow: bool = False             # last block is a fresh copy-on-write page


class RadixPrefixCache:

    def __init__(self, allocator: BlockedAllocator, block_size: int,
                 max_cached_blocks: Optional[int] = None,
                 cow_fn: Optional[Callable[[int, int], None]] = None):
        self.allocator = allocator
        self.block_size = block_size
        self.max_cached_blocks = max_cached_blocks
        # device page copy src_block -> dst_block; None disables COW adoption
        # (full-block sharing still works)
        self.cow_fn = cow_fn
        self.root = _RadixNode((), None, None)
        self.root.chain = ROOT_CHAIN
        self._clock = 0                   # monotonic LRU clock
        self._nodes = 0                   # pages the tree holds references to
        # delta sinks (serving/router.py ClusterPrefixIndex): called
        # ``fn("insert"|"evict", chain_hash)`` whenever a full-block node
        # joins or leaves the tree — the per-replica feed a shared
        # cluster-wide prefix index is built from. Partial leaves never emit
        # (not routable: adoption is COW, not sharing).
        self._listeners: List[Callable[[str, int], None]] = []
        self.stats = PrefixCacheStats()
        # the engine-weight version every cached page's KV was computed
        # under (colocated rollout, runtime/colocated.py): a weight swap
        # bumps this through ``set_weight_version``, which flushes the tree
        # — cached KV from the old weights can never satisfy a post-swap
        # match. Inserts stamp nodes with the current version; matches
        # refuse any node whose stamp trails it (defense in depth on top of
        # the eager flush).
        self.weight_version = 0

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    @property
    def cached_blocks(self) -> int:
        return self._nodes

    @property
    def evictable_blocks(self) -> int:
        """Pages ``evict()`` can actually reclaim right now: refcount-1 nodes
        whose whole subtree is also refcount-1 (eviction peels leaves, so an
        interior page pinned under a shared descendant is unreachable even at
        refcount 1 — counting it would let can_schedule approve an allocation
        that then fails mid-pass). O(nodes); cached-pool sizes are host
        metadata, thousands at most."""
        # iterative (tree depth = cached-prefix page count, which can exceed
        # Python's recursion limit for long prompts at small block sizes):
        # in reversed preorder every child precedes its parent, so one sweep
        # settles subtree-evictability bottom-up
        order = list(self._iter_nodes())
        free: Dict[int, bool] = {}            # id(node) -> subtree evictable
        total = 0
        for node in reversed(order):
            ok = (self.allocator.ref_count(node.block_id) == 1
                  and all(free[id(ch)] for ch in node.children.values())
                  and all(free[id(ch)] for ch in node.partials.values()))
            free[id(node)] = ok
            total += ok
        return total

    def _iter_nodes(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root:
                yield node
            stack.extend(node.children.values())
            stack.extend(node.partials.values())

    def iter_chains(self):
        """Chain hashes of every full-block node currently cached (partial
        leaves excluded — they are not routable). Used by ``add_listener``
        to replay existing state into a late-registered index."""
        for node in self._iter_nodes():
            if node.chain is not None:
                yield node.chain

    def add_listener(self, fn: Callable[[str, int], None],
                     replay: bool = True) -> None:
        """Register a delta sink; ``replay=True`` first emits an ``insert``
        for every full-block node already in the tree, so an index built
        after the replica served traffic starts consistent."""
        if replay:
            for chain in self.iter_chains():
                fn("insert", chain)
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[str, int], None]) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _emit(self, op: str, chain: Optional[int]) -> None:
        if chain is None:
            return
        for fn in self._listeners:
            fn(op, chain)

    def match_len(self, tokens: Sequence[int]) -> int:
        """Tokens the tree could serve for this prompt RIGHT NOW via
        full-block sharing — the cheap longest-cached-match query the
        multi-replica router scores placements with. Pure read: no
        references taken, no LRU touch, no stats, no COW; capped at
        ``len(tokens) - 1`` exactly like ``match`` (the last prompt token
        always prefills fresh)."""
        tokens = [int(t) for t in np.asarray(tokens, np.int64).reshape(-1)]
        bs = self.block_size
        limit = len(tokens) - 1
        node = self.root
        i = 0
        while i + bs <= limit:
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None or child.version != self.weight_version:
                break
            node = child
            i += bs
        return i

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _touch_path(self, node: _RadixNode) -> None:
        t = self._tick()
        while node is not None and node is not self.root:
            node.last_access = t
            node = node.parent

    # ------------------------------------------------------------------ #
    # match (admission path)
    # ------------------------------------------------------------------ #

    def match(self, tokens: Sequence[int]) -> PrefixMatch:
        """Match ``tokens`` against the tree. Returns shared page ids covering
        the longest cached prefix, capped at ``len(tokens) - 1`` so at least
        one prompt token always runs through prefill (the engine needs the
        last token's logits computed fresh). Allocator references for the
        returned pages are already taken for the caller; COW pages come
        exclusively owned at refcount 1."""
        tokens = [int(t) for t in np.asarray(tokens, np.int64).reshape(-1)]
        self.stats.lookups += 1
        self.stats.tokens_requested += len(tokens)
        bs = self.block_size
        limit = len(tokens) - 1           # max tokens we may serve from cache
        out = PrefixMatch()
        node = self.root
        i = 0
        while i + bs <= limit:
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None or child.version != self.weight_version:
                # a stale-version child holds KV computed under swapped-out
                # weights — a hit here would splice wrong KV into a fresh
                # sequence, so the walk refuses and the tail prefills fresh
                break
            out.blocks.append(child.block_id)
            node = child
            i += bs
        out.n_cached = i
        if out.blocks:
            # take the sequence's references BEFORE anything below can evict:
            # the matched path's pages may be tree-only (refcount 1) right
            # now, and _allocate_for_cow may evict to cover its allocation
            self.allocator.share(out.blocks)
            self._touch_path(node)
        # partial-leaf adoption: a flushed tail whose tokens prefix ours
        best = None
        for key, leaf in node.partials.items():
            p = len(key)
            if (i + p <= limit and tuple(tokens[i:i + p]) == key
                    and leaf.version == self.weight_version
                    and (best is None or p > len(best.key))):
                best = leaf
        if best is not None and self.cow_fn is not None:
            # pin the COW source so the eviction inside _allocate_for_cow
            # cannot free the very page we are about to copy from
            self.allocator.share([best.block_id])
            dst = self._allocate_for_cow()
            if dst is not None:
                self.cow_fn(best.block_id, dst)
                out.blocks.append(dst)
                out.n_cached += len(best.key)
                out.cow = True
                self.stats.partial_hits += 1
                self.stats.cow_copies += 1
                self._touch_path(best)
            self.allocator.free([best.block_id])
        if out.blocks:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        self.stats.matched_blocks += len(out.blocks) - (1 if out.cow else 0)
        self.stats.tokens_saved += out.n_cached
        return out

    def _allocate_for_cow(self) -> Optional[int]:
        if self.allocator.free_blocks == 0 and self.evict(1) == 0:
            return None
        return int(self.allocator.allocate(1)[0])

    # ------------------------------------------------------------------ #
    # insert (prefill completion + flush)
    # ------------------------------------------------------------------ #

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               transfer_refs: bool) -> List[int]:
        """File ``blocks`` (logical pages of ``tokens``, in order) into the
        tree.

        ``transfer_refs=False`` (eager insert, sequence still live): the tree
        takes its OWN reference on every page it adopts; the sequence keeps
        all of its references.

        ``transfer_refs=True`` (flush): the sequence's references are consumed
        — transferred to the tree for newly adopted pages, released for pages
        the tree already had (or duplicates of existing content). Returns the
        ids actually freed back to the pool (content already cached under
        other pages, or pages past the known-token coverage).
        """
        tokens = [int(t) for t in np.asarray(tokens, np.int64).reshape(-1)]
        blocks = [int(b) for b in blocks]
        bs = self.block_size
        freed: List[int] = []
        node = self.root
        consumed = 0                      # blocks whose seq-ref we've settled
        stale_stop = False
        i = 0
        while i + bs <= len(tokens) and consumed < len(blocks):
            key = tuple(tokens[i:i + bs])
            blk = blocks[consumed]
            child = node.children.get(key)
            if child is not None and child.version != self.weight_version:
                # a stale-version node survived a deferred flush: never file
                # fresh pages under it (the path above it is unservable) —
                # the remaining refs release below and eviction reclaims it
                stale_stop = True
                break
            if child is None:
                # a partial leaf with this key's prefix may exist; it stays —
                # matches prefer full children, and eviction reclaims it
                child = _RadixNode(key, blk, node)
                child.chain = chain_hash(node.chain, key)
                child.version = self.weight_version
                node.children[key] = child
                self._nodes += 1
                self.stats.insertions += 1
                self._emit("insert", child.chain)
                if not transfer_refs:
                    self.allocator.share([blk])
                # transfer_refs: the seq's reference becomes the tree's
            else:
                if transfer_refs:
                    freed.extend(self.allocator.free([blk]))
            node = child
            consumed += 1
            i += bs
        # partial tail: remaining known tokens that end mid-page
        tip = node                    # deepest node to LRU-touch at the end
        tail = tuple(tokens[i:])
        stale_leaf = (node.partials.get(tail).version != self.weight_version
                      if tail and tail in node.partials else False)
        if tail and consumed < len(blocks) and not stale_stop \
                and not stale_leaf:
            blk = blocks[consumed]
            leaf = node.partials.get(tail)
            if leaf is None:
                leaf = _RadixNode(tail, blk, node)
                leaf.version = self.weight_version
                node.partials[tail] = leaf
                self._nodes += 1
                self.stats.insertions += 1
                if not transfer_refs:
                    self.allocator.share([blk])
            else:
                if transfer_refs:
                    freed.extend(self.allocator.free([blk]))
            # touch through the LEAF: a fresh partial node otherwise keeps
            # last_access=0 and becomes the LRU victim ahead of genuinely
            # old entries — evicting the tail a request just paid to cache
            tip = leaf
            consumed += 1
        if transfer_refs and consumed < len(blocks):
            # pages beyond token coverage (device-generated tokens the host
            # never saw): nothing to key them by — release
            freed.extend(self.allocator.free(blocks[consumed:]))
        self._touch_path(tip)
        if (self.max_cached_blocks is not None
                and self._nodes > self.max_cached_blocks):
            # one call: evict() harvests candidates in a single tree pass
            self.evict(self._nodes - self.max_cached_blocks)
        return freed

    def release(self, tokens: Sequence[int], blocks: Sequence[int]) -> List[int]:
        """Flush-time entry point: insert with reference transfer (completed
        sequences' pages return to the tree, not the free list)."""
        return self.insert(tokens, blocks, transfer_refs=True)

    # ------------------------------------------------------------------ #
    # weight-version flush (colocated rollout weight swap)
    # ------------------------------------------------------------------ #

    def set_weight_version(self, version: int) -> int:
        """Stamp the tree with a new engine-weight version and flush every
        cached page — their KV was computed under the OLD weights, so none
        may satisfy a post-swap match (the cache-invalidation invariant,
        docs/SERVING.md "Colocated rollout"). Called by
        ``engine_v2.swap_weights`` with every sequence already quiesced, so
        the whole tree is refcount-1 and fully evictable; a page still
        shared by a live sequence means the caller broke the quiesce
        contract, and the refusal here surfaces that instead of serving
        stale KV. Eviction deltas flow to the listeners (the cluster prefix
        index must stop routing on the flushed chains). Returns pages
        freed; ``version == weight_version`` is a no-op."""
        if version == self.weight_version:
            return 0
        freed = self.evict(self._nodes) if self._nodes else 0
        if self._nodes:
            raise RuntimeError(
                f"prefix-cache weight-version flush left {self._nodes} "
                "page(s) pinned by live sequences — quiesce (preempt or "
                "flush) every sequence before swapping weights")
        self.weight_version = version
        return freed

    # ------------------------------------------------------------------ #
    # eviction
    # ------------------------------------------------------------------ #

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached pages, least-recently-used
        refcount-1 leaves first (a page some sequence still shares is never
        touched). One tree scan harvests the candidate leaves into a heap;
        evicting a leaf may expose its parent, which joins the heap — so the
        whole call is O(nodes + k log nodes), not a rescan per block.
        Returns pages freed."""
        import heapq
        heap = [(node.last_access, id(node), node)
                for node in self._iter_nodes()
                if node.is_leaf and self.allocator.ref_count(node.block_id) == 1]
        heapq.heapify(heap)
        freed = 0
        while freed < n_blocks and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            if victim.key in parent.children \
                    and parent.children[victim.key] is victim:
                del parent.children[victim.key]
                self._emit("evict", victim.chain)
            else:
                del parent.partials[victim.key]
            self.allocator.free([victim.block_id])
            self._nodes -= 1
            freed += 1
            self.stats.evictions += 1
            if (parent is not self.root and parent.is_leaf
                    and self.allocator.ref_count(parent.block_id) == 1):
                heapq.heappush(heap,
                               (parent.last_access, id(parent), parent))
        return freed
