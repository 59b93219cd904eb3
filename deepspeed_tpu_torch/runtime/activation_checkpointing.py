"""Activation checkpointing (rematerialisation), as the JAX package's
``runtime/activation_checkpointing.py``, over
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``.

The JAX package's remat policies map to torch's:

- ``none`` and ``nothing_saveable``: plain non-reentrant checkpointing
  (everything inside recomputes in the backward);
- ``everything_saveable``: no checkpoint at all (nothing recomputes);
- ``dots_saveable``: selective checkpointing
  (``create_selective_checkpoint_contexts``) that saves the outputs of
  every matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``);
  ``dots_with_no_batch_dims_saveable`` saves ``mm`` and ``addmm`` only;
- ``attn_out_saveable``: saves the attention output. The JAX models tag it
  ``attn_out``; here it is the output of K1's forward op
  (``torch.ops.dstorch.flash_attention_fwd``: o and its logsumexp rows),
  so the backward does not run K1's forward again.

The host-offload policies save the same tensors and move them to host
memory in the forward, bringing them back when the backward recomputes
the region: ``offload_dots`` (the outputs of ``mm``/``addmm``, as JAX's
``offload_dot_with_no_batch_dims``), ``offload_attn_out`` (K1's forward
outputs) and ``named_saveable_policy(names, offload=True)``;
``cpu_checkpointing`` selects ``offload_dots``, as in JAX. Non-reentrant
checkpointing installs saved-tensor hooks of its own, so an outer
``torch.autograd.graph.save_on_cpu`` would never see what a checkpointed
region keeps: the offload happens inside the policy, in a pair of torch
dispatch modes (``_OffloadSave`` copies each saved output into a pinned
host buffer on the current stream; ``_OffloadReplay`` hands the recompute
the copy brought back instead of running the op). ``OFFLOAD_STATS``
counts the tensors and bytes sent to the host. ``configure`` keeps the JAX package's module state: the engine calls it
with its config, and ``layer_chunks`` / ``apply_checkpointed_layers`` read
``number_checkpoints`` and the policy from it. The ZeRO-3 scheduled layer
walk is not ported (it waits for the mesh and ZeRO).

Dropout-free models need no RNG bookkeeping across the recompute:
non-reentrant checkpointing replays the CUDA/CPU RNG state
(``preserve_rng_state``), and progressive layer drop decides its layers
before the chunk runs. ``RNGStatesTracker`` keeps named
``torch.Generator`` seeds for Megatron-style model-parallel dropout.
"""

from __future__ import annotations

import contextlib
import functools
import logging
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
from torch.utils.checkpoint import checkpoint as _torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from deepspeed_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("deepspeed_tpu_torch")

#: the ``everything_saveable`` policy: run without a checkpoint
EVERYTHING = "everything_saveable"

#: tensors and bytes the host-offload policies moved to host memory
OFFLOAD_STATS = {"tensors": 0, "bytes": 0}


class OffloadOps(frozenset):
    """A saving policy whose saved outputs live in host memory between the
    forward and the backward (see the module docstring)."""


def _dots(batch_dims: bool):
    aten = torch.ops.aten
    ops = {aten.mm.default, aten.addmm.default}
    if batch_dims:
        ops |= {aten.bmm.default, aten.baddbmm.default}
    return frozenset(ops)


def _attn_out():
    # importing the kernel module registers the op
    import deepspeed_tpu_torch.ops.kernels.flash_attention  # noqa: F401
    return frozenset({torch.ops.dstorch.flash_attention_fwd.default})


#: name -> zero-arg factory of a policy: None (recompute everything),
#: EVERYTHING (no checkpoint), or the frozenset of ops whose outputs are saved
POLICIES: Dict[str, Callable[[], Any]] = {
    "none": lambda: None,
    "nothing_saveable": lambda: None,
    "everything_saveable": lambda: EVERYTHING,
    "dots_saveable": lambda: _dots(True),
    "dots_with_no_batch_dims_saveable": lambda: _dots(False),
    "attn_out_saveable": _attn_out,
    # host-offload variants (cpu_checkpointing selects offload_dots)
    "offload_dots": lambda: OffloadOps(_dots(False)),
    "offload_attn_out": lambda: OffloadOps(_attn_out()),
}

#: activation names a model tags (the JAX models' ``checkpoint_name``) ->
#: the ops whose outputs they are here
_NAMED = {"attn_out": _attn_out}


def named_saveable_policy(names: Sequence[str], offload: bool = False):
    """Save (``offload``: save to host memory) only the named activations."""
    try:
        ops = frozenset().union(*(_NAMED[n]() for n in names))
    except KeyError as e:
        raise ValueError(f"unknown activation name {e.args[0]!r}; known: "
                         f"{sorted(_NAMED)}") from None
    return OffloadOps(ops) if offload else ops


def resolve_policy(name_or_policy):
    """A registry name, a policy (set of ops, EVERYTHING), or None."""
    if name_or_policy is None or not isinstance(name_or_policy, str):
        return name_or_policy
    if name_or_policy == EVERYTHING:
        return EVERYTHING
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise ValueError(f"unknown remat policy {name_or_policy!r}; known: "
                         f"{sorted(POLICIES)}") from None


# --------------------------------------------------------------------------- #
# module-level configuration (the JAX package's configure / is_configured)
# --------------------------------------------------------------------------- #

class _CheckpointingState:
    def __init__(self):
        self.configured = False
        self.partition_activations = False
        self.cpu_checkpointing = False
        self.contiguous_memory_optimization = False
        self.number_checkpoints: Optional[int] = None
        self.synchronize = False
        self.profile = False
        self.policy = None


_STATE = _CheckpointingState()


def configure(deepspeed_config=None,
              partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None,
              num_checkpoints: Optional[int] = None,
              checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None,
              profile: Optional[bool] = None) -> None:
    """``deepspeed_config`` may be a ``DeepSpeedTPUConfig`` (its
    ``activation_checkpointing`` block is read) or that block; keyword
    arguments override. ``cpu_checkpointing`` selects the
    ``offload_dots`` policy and ``partition_activations`` the
    ``dots_with_no_batch_dims_saveable`` one, as in JAX (on one device there
    is nothing to partition)."""
    cfg = getattr(deepspeed_config, "activation_checkpointing", deepspeed_config)
    if cfg is not None:
        _STATE.partition_activations = getattr(cfg, "partition_activations", False)
        _STATE.cpu_checkpointing = getattr(cfg, "cpu_checkpointing", False)
        _STATE.contiguous_memory_optimization = getattr(
            cfg, "contiguous_memory_optimization", False)
        _STATE.number_checkpoints = getattr(cfg, "number_checkpoints", None)
        _STATE.synchronize = getattr(cfg, "synchronize_checkpoint_boundary", False)
        _STATE.profile = getattr(cfg, "profile", False)
    if partition_activations is not None:
        _STATE.partition_activations = partition_activations
    if contiguous_checkpointing is not None:
        _STATE.contiguous_memory_optimization = contiguous_checkpointing
    if num_checkpoints is not None:
        _STATE.number_checkpoints = num_checkpoints
    if checkpoint_in_cpu is not None:
        _STATE.cpu_checkpointing = checkpoint_in_cpu
    if synchronize is not None:
        _STATE.synchronize = synchronize
    if profile is not None:
        _STATE.profile = profile
    if _STATE.cpu_checkpointing:
        _STATE.policy = POLICIES["offload_dots"]()
    elif _STATE.partition_activations:
        _STATE.policy = POLICIES["dots_with_no_batch_dims_saveable"]()
    else:
        _STATE.policy = None
    _STATE.configured = True
    logger.debug("activation checkpointing configured: partition=%s cpu=%s n=%s",
                 _STATE.partition_activations, _STATE.cpu_checkpointing,
                 _STATE.number_checkpoints)


def is_configured() -> bool:
    return _STATE.configured


def reset() -> None:
    global _STATE
    _STATE = _CheckpointingState()


def current_policy():
    return _STATE.policy if _STATE.configured else None


# --------------------------------------------------------------------------- #
# checkpoint(): the user-facing wrapper
# --------------------------------------------------------------------------- #

def _policy_fn(saved: frozenset, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


class _Host:
    """A saved output's host copy and the device it came from (None: it
    came from the CPU)."""

    __slots__ = ("tensor", "device")

    def __init__(self, tensor: torch.Tensor, device):
        self.tensor, self.device = tensor, device


def _to_host(x):
    """A saved output's host copy: pinned and queued on the current stream
    for a CUDA tensor (the backward's copy back runs on the same stream,
    after it), a plain copy for a CPU one."""
    if not isinstance(x, torch.Tensor):
        return x
    OFFLOAD_STATS["tensors"] += 1
    OFFLOAD_STATS["bytes"] += x.numel() * x.element_size()
    if not x.is_cuda:
        return _Host(x.detach().clone(), None)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return _Host(host, x.device)


def _from_host(entry):
    if not isinstance(entry, _Host):
        return entry
    return entry.tensor if entry.device is None \
        else entry.tensor.to(entry.device, non_blocking=True)


class _OffloadSave(TorchDispatchMode):
    """The forward's mode: the outputs of ``ops`` go to host memory, in the
    order the ops ran."""

    def __init__(self, ops: frozenset, store: Dict):
        super().__init__()
        self.ops, self.store = ops, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.ops:
            self.store[func].append(tree_map(_to_host, out))
        return out


class _OffloadReplay(TorchDispatchMode):
    """The recompute's mode: each op of ``ops`` returns its saved output,
    brought back to the device, instead of running; the rest recompute."""

    def __init__(self, ops: frozenset, store: Dict):
        super().__init__()
        self.ops, self.store = ops, store
        self.counter: Dict[Any, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in self.ops:
            return func(*args, **(kwargs or {}))
        i = self.counter[func]
        self.counter[func] += 1
        entry, self.store[func][i] = self.store[func][i], None
        if entry is None:
            raise RuntimeError(f"{func}: saved output {i} was already consumed (a "
                               "checkpointed region is recomputed once)")
        return tree_map(_from_host, entry, is_leaf=lambda x: isinstance(x, _Host))


def _offload_contexts(ops: frozenset):
    store: Dict = defaultdict(list)
    return _OffloadSave(ops, store), _OffloadReplay(ops, store)


def _run(function: Callable, args: Tuple, kwargs: Dict, policy):
    if policy == EVERYTHING:
        return function(*args, **kwargs)
    if policy is None:
        return _torch_checkpoint(function, *args, use_reentrant=False, **kwargs)
    if isinstance(policy, OffloadOps):
        ctx = functools.partial(_offload_contexts, policy)
    else:
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                functools.partial(_policy_fn, policy))
    return _torch_checkpoint(function, *args, use_reentrant=False, context_fn=ctx, **kwargs)


def checkpoint(function: Callable, *args, policy=None, **kwargs):
    """Recompute ``function(*args)`` in the backward under ``policy`` (a
    registry name or policy; default: the configured one)."""
    pol = resolve_policy(policy) if policy is not None else current_policy()
    return _run(function, args, kwargs, pol)


def checkpoint_wrapper(function: Callable, policy=None) -> Callable:
    """``function`` wrapped so each call recomputes in the backward
    (decorator form)."""
    pol = resolve_policy(policy) if policy is not None else current_policy()

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return _run(function, args, kwargs, pol)
    return wrapped


class RematModule(torch.nn.Module):
    """An ``nn.Module`` whose forward recomputes in the backward: the torch
    form of the JAX package's ``apply_remat`` (``nn.remat`` of a flax
    class)."""

    def __init__(self, module: torch.nn.Module, policy=None):
        super().__init__()
        self.module = module
        self.policy = resolve_policy(policy) if policy is not None else current_policy()

    def forward(self, *args, **kwargs):
        return _run(self.module, args, kwargs, self.policy)


def apply_remat(module: torch.nn.Module, remat: bool = True, policy=None) -> torch.nn.Module:
    """``module`` wrapped in :class:`RematModule` (unchanged without
    ``remat``)."""
    return RematModule(module, policy) if remat else module


def layer_chunks(n_layers: int) -> List[Tuple[int, int]]:
    """Chunk boundaries [(start, end), ...]: ``number_checkpoints`` chunks
    (only their boundary activations are kept), one a layer by default."""
    k = _STATE.number_checkpoints if _STATE.configured and _STATE.number_checkpoints \
        else n_layers
    k = max(1, min(int(k), n_layers))
    per = -(-n_layers // k)  # ceil
    return [(s, min(s + per, n_layers)) for s in range(0, n_layers, per)]


def apply_checkpointed_layers(module, carry, call_layer: Callable, n_layers: int,
                              remat: bool = True, policy=None):
    """Apply ``n_layers`` layers, ``call_layer(module, carry, i) -> carry``,
    with chunked rematerialisation (:func:`layer_chunks`) under ``policy``
    (a registry name; default: the configured one)."""
    if not remat:
        for i in range(n_layers):
            carry = call_layer(module, carry, i)
        return carry
    pol = resolve_policy(policy) if policy is not None else current_policy()

    def chunk(c, s, e):
        for i in range(s, e):
            c = call_layer(module, c, i)
        return c

    for s, e in layer_chunks(n_layers):
        carry = _run(chunk, (carry, s, e), {}, pol)
    return carry


# --------------------------------------------------------------------------- #
# RNG state tracker
# --------------------------------------------------------------------------- #

class RNGStatesTracker:
    """Named ``torch.Generator`` registry with a fork context (the JAX
    package's tracker over PRNG keys): ``fork(name)`` yields the named
    generator, whose state advances with each draw, so forks in turn draw
    fresh numbers and the same seed replays the same stream. The generators
    live on ``device``: ``None`` (the default) means the card, resolved
    when a generator is made, so building a tracker (the module-level one
    included) needs no CUDA."""

    def __init__(self, device=None):
        self.device = device
        self.states_: Dict[str, torch.Generator] = {}

    def reset(self):
        self.states_.clear()

    def get_states(self) -> Dict[str, torch.Tensor]:
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states: Dict[str, torch.Tensor]):
        self.states_ = {}
        for name, st in states.items():
            g = torch.Generator(device=resolve_device(self.device))
            g.set_state(st)
            self.states_[name] = g

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise ValueError(f"rng state {name} already present")
        self.states_[name] = torch.Generator(
            device=resolve_device(self.device)).manual_seed(int(seed))

    @contextlib.contextmanager
    def fork(self, name: str = "model-parallel-rng"):
        if name not in self.states_:
            raise KeyError(f"rng state {name} not added")
        yield self.states_[name]


_RNG_TRACKER = RNGStatesTracker()


def get_cuda_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_seed(base_seed: int, tp_rank: int, device=None) -> torch.Generator:
    """A generator decorrelated per tensor-parallel rank: seeded from
    (base seed, rank), as the JAX package folds the rank into its key. On
    the card unless ``device`` says otherwise."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        mix_seed(base_seed, tp_rank))


def mix_seed(*parts: int) -> int:
    """A 63-bit seed mixed from integers (numpy's SeedSequence hash), so
    (base, step) and (base, step + 1) seed unrelated streams."""
    return int(np.random.SeedSequence([int(p) & (2 ** 63 - 1) for p in parts])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
