"""Elastic training math: valid (micro-batch, GAS, world-size) combinations
(the JAX package's ``elasticity/elasticity.py``, copied).

Parity: ``deepspeed/elasticity/elasticity.py`` — given a target
``max_train_batch_size``, a preference list of ``micro_batch_sizes``, and host
bounds, compute a final global batch size plus the set of world sizes it can run
at unchanged (``_get_compatible_gpus_v01`` :83, v0.2 with model-parallel :126,
``compute_elastic_config`` :233). Keeping the global batch invariant as hosts
join/leave is what makes resumption loss-curve-neutral.

World-size granularity is a host (a multiple of the devices per host),
which plays the role the v0.2 model-parallel divisor plays in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

ELASTICITY_DEFAULT_VERSION = 0.2

# Highly-composite-style ladder used to propose batch sizes with many divisors
# (the reference uses a hard-coded highly-composite-number list for the same
# purpose: maximize the number of compatible world sizes).
_COMPOSITE_LADDER = [1, 2, 4, 6, 8, 12, 16, 24, 32, 36, 48, 60, 64, 96, 120,
                     128, 180, 240, 256, 360, 480, 512, 720, 840, 1024, 1260,
                     1680, 2520, 5040]


class ElasticityError(ValueError):
    pass


def _candidate_batch_sizes(micro_batches: List[int],
                           max_acceptable_batch_size: int) -> List[int]:
    """Batch sizes ≤ max that are (micro_batch x composite) for some micro batch."""
    candidates = set()
    for mb in micro_batches:
        for k in _COMPOSITE_LADDER:
            b = mb * k
            if b <= max_acceptable_batch_size:
                candidates.add(b)
            else:
                break
    return sorted(candidates)


def _valid_world_sizes(batch_size: int, micro_batches: List[int],
                       min_gpus: int, max_gpus: int,
                       granularity: int = 1) -> List[int]:
    """World sizes w (multiples of granularity) s.t. batch = mb * gas * w for
    some preferred micro batch and integer gas ≥ 1."""
    valid = set()
    for mb in micro_batches:
        if batch_size % mb:
            continue
        per_mb = batch_size // mb  # gas * world
        w = granularity
        while w <= min(per_mb, max_gpus):
            if per_mb % w == 0 and w >= min_gpus:
                valid.add(w)
            w += granularity
    return sorted(valid)


def _get_compatible_gpus_v01(micro_batches: List[int],
                             max_acceptable_batch_size: int,
                             min_gpus: int = 1,
                             max_gpus: Optional[int] = None,
                             prefer_larger: bool = True
                             ) -> Tuple[int, List[int]]:
    """v0.1: pick the batch size with the most compatible world sizes.

    Parity: ``elasticity.py:83``."""
    max_gpus = max_gpus or max_acceptable_batch_size
    best: Tuple[int, List[int]] = (0, [])
    for b in _candidate_batch_sizes(micro_batches, max_acceptable_batch_size):
        valid = _valid_world_sizes(b, micro_batches, min_gpus, max_gpus)
        better = len(valid) > len(best[1])
        tie = len(valid) == len(best[1]) and valid
        if better or (tie and ((b > best[0]) == prefer_larger)):
            best = (b, valid)
    if not best[1]:
        raise ElasticityError(
            f"no compatible world sizes for micro_batches={micro_batches}, "
            f"max_batch={max_acceptable_batch_size}, gpus=[{min_gpus},{max_gpus}]")
    return best


def _get_compatible_gpus_v02(micro_batches: List[int],
                             max_acceptable_batch_size: int,
                             current_num_gpus: int,
                             min_gpus: int = 1,
                             max_gpus: Optional[int] = None,
                             prefer_larger: bool = True,
                             num_gpus_per_node: int = 1,
                             model_parallel_size: int = 1
                             ) -> Tuple[int, List[int], int]:
    """v0.2: model-parallel-aware — world sizes step in units of
    mp_size-compatible node groups. Parity: ``elasticity.py:126``."""
    max_gpus = max_gpus or max_acceptable_batch_size
    if model_parallel_size > 1:
        # data-parallel degree steps in groups of mp ranks: the tensor-parallel
        # span in devices, constrained to divide or be divided by the host size
        dp_gran = model_parallel_size // num_gpus_per_node \
            if model_parallel_size >= num_gpus_per_node else 1
        dp_gran = max(dp_gran, 1)
        granularity = model_parallel_size * dp_gran
    else:
        granularity = num_gpus_per_node
    best: Tuple[int, List[int]] = (0, [])
    for b in _candidate_batch_sizes(micro_batches, max_acceptable_batch_size):
        valid = _valid_world_sizes(b, micro_batches, min_gpus, max_gpus,
                                   granularity=granularity)
        better = len(valid) > len(best[1])
        tie = len(valid) == len(best[1]) and valid
        if better or (tie and ((b > best[0]) == prefer_larger)):
            best = (b, valid)
    if not best[1]:
        raise ElasticityError(
            f"no compatible world sizes (granularity={granularity}) for "
            f"micro_batches={micro_batches}, max_batch={max_acceptable_batch_size}")
    final_batch, valid = best
    if current_num_gpus in valid:
        chosen = current_num_gpus
    else:
        under = [w for w in valid if w <= current_num_gpus]
        chosen = max(under) if under else min(valid)
    return final_batch, valid, chosen


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "",
                           world_size: int = 0, return_microbatch: bool = False):
    """Resolve the elastic section of a config dict.

    Parity: ``compute_elastic_config`` (``elasticity.py:233``). Returns
    ``(final_batch_size, valid_world_sizes[, micro_batch_size])``; when
    ``world_size`` is given, also validates it and picks the micro batch."""
    e = ds_config.get("elasticity", {})
    if not e or not e.get("enabled", False):
        raise ElasticityError("elasticity section missing or disabled")
    micro_batches = sorted(e.get("micro_batch_sizes", [2, 4, 6]), reverse=True)
    max_batch = e["max_train_batch_size"]
    min_gpus = e.get("min_gpus", 1)
    max_gpus = e.get("max_gpus", max_batch)
    prefer_larger = e.get("prefer_larger_batch", True)
    version = float(e.get("version", ELASTICITY_DEFAULT_VERSION))
    if any(mb <= 0 for mb in micro_batches):
        raise ElasticityError(f"micro batches must be positive: {micro_batches}")
    if version >= 0.2:
        final_batch, valid, _ = _get_compatible_gpus_v02(
            micro_batches, max_batch, current_num_gpus=world_size or min_gpus,
            min_gpus=min_gpus, max_gpus=max_gpus, prefer_larger=prefer_larger,
            num_gpus_per_node=e.get("num_gpus_per_node", 1),
            model_parallel_size=e.get("model_parallel_size", 1))
    else:
        final_batch, valid = _get_compatible_gpus_v01(
            micro_batches, max_batch, min_gpus, max_gpus, prefer_larger)
    if world_size > 0 and world_size not in valid:
        raise ElasticityError(
            f"world size {world_size} not in compatible set {valid}")
    if return_microbatch or world_size > 0:
        micro = None
        for mb in micro_batches:
            if world_size and final_batch % (mb * world_size) == 0:
                micro = mb
                break
        if micro is None:
            micro = micro_batches[0]
        if return_microbatch:
            return final_batch, valid, micro
    return final_batch, valid


def validate_elastic_nodes(n_nodes: int, min_nodes: int, max_nodes: int):
    """Launcher-side bound check (parity: ``launcher/runner.py:373-392``)."""
    if min_nodes > 0 and n_nodes < min_nodes:
        raise ElasticityError(f"{n_nodes} nodes < min_elastic_nodes {min_nodes}")
    if max_nodes > 0 and n_nodes > max_nodes:
        raise ElasticityError(f"{n_nodes} nodes > max_elastic_nodes {max_nodes}")
