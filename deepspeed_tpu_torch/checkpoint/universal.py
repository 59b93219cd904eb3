"""Universal checkpoints: per-parameter fragments loadable at any
parallelism (the JAX package's ``checkpoint/universal.py``, the same
layout, so a universal directory written by either package loads in the
other).

Engine checkpoints already store full logical tensors per parameter, so
conversion is a re-keying into the universal on-disk layout, and loading
re-shards whole tensors (on one device: copies them into the live ones).

Universal layout::

    <out_dir>/
      zero/
        <param_key>/fp32.npy
        <param_key>/exp_avg.npy          (per optimizer-state key)
        ...
      universal_meta.json                {keys, scalars, source_tag, client_state}

The layout is also the interchange point for checkpoints produced by *other*
systems: anything that can emit one .npy per parameter fragment can be loaded
into this engine.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.state import (CLIENT_FILE, MODEL_FILE, OPTIM_FILE,
                                                  copy_plan, flatten_tree, load_into,
                                                  resolve_load_tag)
from deepspeed_tpu_torch.utils.logging import log_dist

META_FILE = "universal_meta.json"
ZERO_DIR = "zero"

_SCALARS = ("step", "skipped", "scaler/scale", "scaler/growth_tracker",
            "scaler/hysteresis", "opt/step")


def _param_dir(out_dir: str, key: str) -> str:
    return os.path.join(out_dir, ZERO_DIR, key)


def ds_to_universal(ckpt_dir: str, out_dir: str, tag: Optional[str] = None) -> str:
    """Convert an engine checkpoint into universal per-parameter fragments
    (single-pass: the tag already holds whole tensors)."""
    # same torn-checkpoint discipline as every load path: tag=None resolves
    # to the newest COMPLETE tag (a `latest` left pointing at a mid-write
    # casualty falls back instead of crashing inside np.load), an explicit
    # torn tag raises CheckpointCorrupt with the reason
    tag = resolve_load_tag(ckpt_dir, tag)
    src = os.path.join(ckpt_dir, tag)
    model = dict(np.load(os.path.join(src, MODEL_FILE)))
    optim = dict(np.load(os.path.join(src, OPTIM_FILE)))

    os.makedirs(os.path.join(out_dir, ZERO_DIR), exist_ok=True)
    keys = sorted(model)
    for key, val in model.items():
        pdir = _param_dir(out_dir, key)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, "fp32.npy"), np.asarray(val, np.float32))
    # optimizer state fragments: optim keys look like "opt/<state_key>/<param_key>"
    for okey, val in optim.items():
        if not okey.startswith("opt/") or okey in _SCALARS:
            continue
        rest = okey[len("opt/"):]
        state_key, _, param_key = rest.partition("/")
        if not param_key:  # scalar like opt/step
            continue
        pdir = _param_dir(out_dir, param_key)
        os.makedirs(pdir, exist_ok=True)
        np.save(os.path.join(pdir, f"{state_key}.npy"), np.asarray(val))

    meta = {"keys": keys,
            "scalars": {k: np.asarray(optim[k]).item()
                        for k in optim if k in _SCALARS},
            "source_tag": tag}
    client = os.path.join(src, CLIENT_FILE)
    if os.path.exists(client):
        with open(client) as f:
            meta["client_state"] = json.load(f)
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    log_dist(f"universal checkpoint written to {out_dir}", ranks=[0])
    return out_dir


def load_universal(out_dir: str) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, np.ndarray], dict]:
    """Read fragments back: (master_flat, optim_flat, meta) — each
    parameter's fp32 value + optimizer states, addressed by name."""
    with open(os.path.join(out_dir, META_FILE)) as f:
        meta = json.load(f)
    master: Dict[str, np.ndarray] = {}
    optim: Dict[str, np.ndarray] = {}
    zero_root = os.path.join(out_dir, ZERO_DIR)
    for key in meta["keys"]:
        pdir = os.path.join(zero_root, key)
        master[key] = np.load(os.path.join(pdir, "fp32.npy"))
        for fname in os.listdir(pdir):
            if fname == "fp32.npy" or not fname.endswith(".npy"):
                continue
            state_key = fname[:-len(".npy")]
            optim[f"opt/{state_key}/{key}"] = np.load(os.path.join(pdir, fname))
    for k, v in meta.get("scalars", {}).items():
        optim[k] = np.asarray(v)
    return master, optim, meta


def load_universal_into_engine(engine, out_dir: str,
                               load_optimizer_states: bool = True,
                               load_module_only: bool = False) -> dict:
    """Load a universal checkpoint INTO a live engine's tensors: the master
    (and the compute-dtype params recast from it), the optimizer states the
    directory holds, ``step``, ``skipped``, the scaler's three leaves and the
    counters; the lr follows from ``step``. An offload engine's host-flow
    leaves go to its host optimizer."""
    master_flat, optim_flat, meta = load_universal(out_dir)
    state = engine.state
    plan = copy_plan(state["master"], master_flat)
    scalars = meta.get("scalars", {})
    if load_optimizer_states and not load_module_only:
        # the optimizer states the directory holds, cast to the live dtypes
        present = {k[len("opt/"):]: v for k, v in optim_flat.items() if k.startswith("opt/")}
        live = {k: t for k, t in flatten_tree(state["opt"]).items() if k in present}
        plan += copy_plan(live, {k: np.asarray(present[k]).astype(_np_dtype(t))
                                 .reshape(tuple(t.shape)) for k, t in live.items()})
        named = {"step": state["step"], "skipped": state["skipped"],
                 **{f"scaler/{n}": t for n, t in state["scaler"].items()}}
        named = {k: t for k, t in named.items() if k in scalars}
        plan += copy_plan(named, {k: np.asarray(scalars[k], _np_dtype(t))
                                  for k, t in named.items()})
    load_into(state, plan)
    if getattr(engine, "_offload", None) is not None:
        # an offload engine's host-flow master and moments
        need_optim = load_optimizer_states and not load_module_only
        engine._offload_load_host(master_flat, optim_flat if need_optim else None)
    client = meta.get("client_state", {})
    if not load_module_only:
        engine.global_steps = int(client.get("global_steps", scalars.get("step", 0)))
        engine.global_samples = int(client.get("global_samples", 0))
        engine.micro_steps = int(client.get("micro_steps", 0))
    return client


def _np_dtype(t) -> np.dtype:
    return torch.empty((), dtype=t.dtype).numpy().dtype
