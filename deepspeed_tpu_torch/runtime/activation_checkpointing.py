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

The host-offload policies (``offload_dots``, ``offload_attn_out``) and
``cpu_checkpointing`` belong to the offload tier and raise by name.
``configure`` keeps the JAX package's module state: the engine calls it
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
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("deepspeed_tpu_torch")

#: the ``everything_saveable`` policy: run without a checkpoint
EVERYTHING = "everything_saveable"
# host offload of saved activations: the offload tier
_OFFLOAD_POLICIES = ("offload_dots", "offload_attn_out")


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
}


def resolve_policy(name_or_policy):
    """A registry name, a policy (set of ops, EVERYTHING), or None."""
    if name_or_policy is None or not isinstance(name_or_policy, str):
        return name_or_policy
    if name_or_policy == EVERYTHING:
        return EVERYTHING
    if name_or_policy in _OFFLOAD_POLICIES:
        raise NotImplementedError(
            f"remat policy '{name_or_policy}' (host offload of saved activations): "
            "not ported to deepspeed_tpu_torch yet")
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise ValueError(f"unknown remat policy {name_or_policy!r}; known: "
                         f"{sorted(POLICIES) + list(_OFFLOAD_POLICIES)}") from None


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
    arguments override. ``partition_activations`` selects the
    ``dots_with_no_batch_dims_saveable`` policy, as in JAX (on one device
    there is nothing to partition); ``cpu_checkpointing`` raises."""
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
        _STATE.cpu_checkpointing = False
        raise NotImplementedError(
            "activation_checkpointing.cpu_checkpointing (host offload of saved "
            "activations): not ported to deepspeed_tpu_torch yet")
    _STATE.policy = POLICIES["dots_with_no_batch_dims_saveable"]() \
        if _STATE.partition_activations else None
    _STATE.configured = True
    logger.debug("activation checkpointing configured: partition=%s n=%s",
                 _STATE.partition_activations, _STATE.number_checkpoints)


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


def _run(function: Callable, args: Tuple, kwargs: Dict, policy):
    if policy == EVERYTHING:
        return function(*args, **kwargs)
    if policy is None:
        return _torch_checkpoint(function, *args, use_reentrant=False, **kwargs)
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
