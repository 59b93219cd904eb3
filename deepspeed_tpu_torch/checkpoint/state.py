"""Engine checkpoint save/load (the JAX package's ``checkpoint/state.py``).

A tag holds full logical tensors, so any engine of the same model can
reload it, and the files are the JAX package's byte format: a tag written
by either package loads in the other. The file names, ``latest``,
``manifest.json`` (per-array crc32 over the same contiguous bytes) and
``client_state.json`` are the same, and the npz keys are the JAX package's
``/``-joined tree paths (:func:`flatten_tree`).

Durability contract: each tag carries a ``manifest.json`` written only
after every data file is durable, listing per-array crc32 checksums; the
``latest`` tag file is written atomically (tmp + rename) and only after the
manifest. A reader therefore classifies any tag as *complete* (manifest
present, files open, checksums available) or *torn* (a crash landed
mid-write) — and resume-by-latest (``find_resume_tag``) skips torn tags
back to the newest complete one with a warning instead of dying on a
half-written directory.

Layout::

    save_dir/
      latest                      <- text file holding the newest tag
      <tag>/
        model_states.npz          <- master fp32 params, '/'-joined key paths
        optim_states.npz          <- optimizer moments + step + loss-scale state
        client_state.json         <- counters + user dict
        manifest.json             <- per-array crc32s; written LAST (completeness marker)

The files hold fp32 masters and moments and int32/f32 scalars only. A
bfloat16 leaf has no numpy dtype without ``ml_dtypes`` (absent on the
card), so :func:`drain_to_host` refuses one by name.

Device traffic: a save reads the device once, in :func:`drain_to_host`
(copies issued ``non_blocking`` into fresh pinned buffers, then one stream
sync); a load writes INTO the engine's live tensors (the module's
parameters stay the same objects) and recasts the compute-dtype params from
the master, as the training step does.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.threads import make_lock

MODEL_FILE = "model_states.npz"
OPTIM_FILE = "optim_states.npz"
CLIENT_FILE = "client_state.json"
MANIFEST_FILE = "manifest.json"
LATEST = "latest"

_SEP = "/"

#: policed device->host drains made so far (:func:`drain_to_host`)
DRAINS = {"count": 0}


class CheckpointCorrupt(RuntimeError):
    """An explicitly requested tag is torn/partially written, or a verified
    load found a checksum mismatch."""


# --------------------------------------------------------------------------- #
# flattening: the JAX package's key paths over nested dicts of tensors
# --------------------------------------------------------------------------- #

def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in the JAX tree order: dict keys sorted, sequences by
    index, None an empty subtree."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by ``/``-joined path. A level keyed by ``/``-joined flax
    names (the port's flat parameter dicts) gives the same strings as the
    JAX package's nested trees: ``opt/exp_avg/h_0/attn/c_attn/kernel``."""
    return {prefix + _SEP.join(path): leaf for path, leaf in _leaves(tree)}


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def unflatten_into(template: Any, flat: Mapping[str, Any], prefix: str = "") -> Any:
    """Rebuild a tree congruent with ``template`` from flat key -> array.
    Template-driven: every key is built from the template's path, so a
    ``/`` inside a template key is never parsed back."""

    def build(node, path):
        if isinstance(node, Mapping):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (str(i),)) for i, v in enumerate(node))
        if node is None:
            return None
        key = prefix + _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor '{key}'")
        arr = flat[key]
        if _shape(arr) != _shape(node):
            raise ValueError(f"checkpoint tensor '{key}' shape {_shape(arr)} != "
                             f"expected {_shape(node)}")
        return arr

    return build(template, ())


# --------------------------------------------------------------------------- #
# the policed drain and the in-place upload
# --------------------------------------------------------------------------- #

def drain_to_host(*flats: Mapping[str, Any]) -> Tuple[Dict[str, np.ndarray], ...]:
    """THE device->host read of a checkpoint: every leaf of every flat
    dict copied into a FRESH host buffer, never a view of a live tensor (on
    the CPU ``t.to("cpu")`` IS ``t``, and the engine mutates its state in
    place: an aliased snapshot would let an async writer write the next
    step's bytes). CUDA leaves go ``non_blocking`` into pinned buffers from
    torch's caching host allocator — a buffer returns to it only when the
    writer drops its arrays, after the commit — then ONE sync of the
    current stream. Counted in ``DRAINS``."""
    DRAINS["count"] += 1
    staged: List[Dict[str, Any]] = []
    cuda = False
    for flat in flats:
        out = {}
        for k, v in flat.items():
            if not isinstance(v, torch.Tensor):
                out[k] = np.array(v)
                continue
            if v.dtype == torch.bfloat16:
                raise TypeError(f"checkpoint leaf '{k}' is bfloat16: checkpoint files "
                                "hold fp32 and int32 leaves only (numpy has no bfloat16)")
            t = v.detach()
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                cuda = True
            else:
                host = t.clone()
            out[k] = host
        staged.append(out)
    if cuda:
        torch.cuda.current_stream().synchronize()
    return tuple({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                  for k, v in out.items()} for out in staged)


def copy_plan(template: Any, flat: Mapping[str, np.ndarray]
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(live tensor, host tensor) pairs for every leaf of ``template``, the
    keys, shapes and dtypes checked: a load checks every plan before
    :func:`load_into` writes the first tensor."""
    plan = []
    for key, dst in flatten_tree(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor '{key}'")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint tensor '{key}' shape {tuple(arr.shape)} != "
                             f"expected {tuple(dst.shape)}")
        src = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if src.dtype != dst.dtype:
            raise ValueError(f"checkpoint tensor '{key}' dtype {src.dtype} != "
                             f"expected {dst.dtype}")
        plan.append((dst, src))
    return plan


def load_into(state: Mapping[str, Any], plan: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """Write the host tensors INTO the live ones, so every reference to a
    tensor — the module's ``nn.Parameter`` s first — sees the loaded values;
    then recast the compute-dtype params from the fp32 master, in place, as
    the training step does after its update, and wait for the device."""
    master = state["master"]
    with torch.no_grad():
        for dst, src in plan:
            dst.copy_(src)
        if "params" in state and master:
            # (an offload engine's master holds only its device-flow leaves)
            torch._foreach_copy_([state["params"][n] for n in master],
                                 [master[n] for n in master])
    if state["step"].is_cuda:
        torch.cuda.current_stream().synchronize()


# --------------------------------------------------------------------------- #
# manifest + completeness
# --------------------------------------------------------------------------- #

def _array_crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def checksum_flat(flat: Dict[str, np.ndarray]) -> Dict[str, int]:
    return {k: _array_crc(v) for k, v in flat.items()}


def write_manifest(ckpt_dir: str, tag: str,
                   checksums: Dict[str, Dict[str, int]]) -> None:
    """``checksums``: file name -> {array key -> crc32}. Written atomically
    and ONLY after the listed files are durable — manifest presence is the
    tag's completeness marker."""
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"format": 1, "tag": tag, "files": checksums}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_manifest(ckpt_dir: str) -> Optional[dict]:
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _npz_openable(path: str) -> bool:
    """Cheap torn-file detection: a truncated npz loses its zip central
    directory, so opening it (not reading the arrays) already fails."""
    try:
        with zipfile.ZipFile(path) as zf:
            return zf.namelist() is not None
    except (OSError, zipfile.BadZipFile):
        return False


def tag_problem(load_dir: str, tag: str, need_optim: bool = True,
                verify: bool = False) -> Optional[str]:
    """None when the tag is loadable; otherwise a human-readable reason it
    is torn (missing dir/file, truncated npz, bad manifest/checksum)."""
    ckpt_dir = os.path.join(load_dir, tag)
    if not os.path.isdir(ckpt_dir):
        return f"tag dir {ckpt_dir} does not exist"
    files = [MODEL_FILE] + ([OPTIM_FILE] if need_optim else [])
    for fname in files:
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            return f"missing {fname}"
        if not _npz_openable(path):
            return f"truncated/corrupt {fname}"
    # the counters file is part of completeness: a crash between the npz
    # writes and the client json leaves weights that would silently resume
    # at global_steps=0 (missing) or die in json parsing (torn)
    client_path = os.path.join(ckpt_dir, CLIENT_FILE)
    if not os.path.exists(client_path):
        return f"missing {CLIENT_FILE}"
    try:
        with open(client_path) as f:
            json.load(f)
    except (OSError, ValueError):
        return f"truncated/corrupt {CLIENT_FILE}"
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        if os.path.exists(os.path.join(ckpt_dir, MANIFEST_FILE)):
            return "unreadable manifest.json"
        # pre-manifest checkpoints stay loadable; verification is best-effort
        if verify:
            logger.warning(f"checkpoint {ckpt_dir}: no manifest — verify "
                           "falls back to npz integrity only")
        return None
    for fname in files:
        if fname not in manifest.get("files", {}):
            return f"{fname} not listed in manifest"
    if verify:
        for fname in files:
            try:
                flat = dict(np.load(os.path.join(ckpt_dir, fname),
                                    allow_pickle=False))
            except Exception as e:
                return f"unreadable {fname}: {e}"
            bad = verify_flat(flat, manifest, fname)
            if bad:
                return f"checksum mismatch in {fname}: {bad[:4]}"
    return None


def verify_flat(flat: Dict[str, np.ndarray], manifest: Optional[dict],
                fname: str) -> List[str]:
    """Array keys in ``flat`` whose crc32 disagrees with the manifest (or
    are missing from it). Empty list = verified (or no manifest to check)."""
    if not manifest:
        return []
    expected = manifest.get("files", {}).get(fname)
    if expected is None:
        return []
    bad = [k for k in flat
           if k not in expected or _array_crc(flat[k]) != int(expected[k])]
    bad += [k for k in expected if k not in flat]
    return bad


_latest_lock = make_lock("checkpoint.latest")


def _tag_step(tag: Optional[str]) -> int:
    """Step number of a ``...step<N>``-suffixed tag (``rolling_step120`` ->
    120, ``global_step80`` -> 80), -1 for anything else. Only the explicit
    ``step`` spelling counts as orderable: arbitrary trailing digits
    (``run_20260803``, ``c2``) are NOT step numbers, and misreading them
    would freeze or roll back the monotonic ``latest`` guard."""
    if not tag:
        return -1
    digits = ""
    for ch in reversed(tag):
        if ch.isdigit():
            digits = ch + digits
        else:
            break
    if not digits or not tag[:len(tag) - len(digits)].endswith("step"):
        return -1
    return int(digits)


def write_latest_tag(save_dir: str, tag: str, monotonic: bool = False) -> None:
    """Atomic ``latest`` flip: a crash can leave a stale latest, never a
    torn one. Safe under concurrent flips (the rolling committer thread and
    a user ``save_checkpoint`` can race): each writer stages through its own
    tmp name, serialized by an in-process lock.

    ``monotonic=True`` (the rolling committer): skip the flip when the
    current ``latest`` already names a HIGHER step — a background commit of
    an older rolling tag must never roll the resume point backwards past a
    user save that landed in between. Only applies when both tags carry
    step numbers; un-numbered user tags cannot be ordered, so they are
    always overwritten."""
    path = os.path.join(save_dir, LATEST)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with _latest_lock:
        if monotonic:
            cur_step = _tag_step(read_latest_tag(save_dir))
            new_step = _tag_step(tag)
            if 0 <= new_step < cur_step:
                logger.warning(
                    f"not moving 'latest' backwards to '{tag}' "
                    f"(step {new_step} < current step {cur_step})")
                return
        with open(tmp, "w") as f:
            f.write(tag)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)


def read_latest_tag(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            tag = f.read().strip()
    except OSError as e:
        logger.warning(f"unreadable 'latest' in {load_dir}: {e}")
        return None
    return tag or None


def _tag_sort_key(load_dir: str, tag: str):
    """Newest-first ordering: step number parsed from a trailing integer in
    the tag when present (``global_step120`` > ``global_step80``), dir mtime
    as the tiebreak/fallback."""
    try:
        mtime = os.path.getmtime(os.path.join(load_dir, tag))
    except OSError:
        mtime = 0.0
    return (_tag_step(tag), mtime)


def find_resume_tag(load_dir: str, need_optim: bool = True,
                    verify: bool = False) -> Optional[str]:
    """The newest COMPLETE tag to resume from.

    Tries the ``latest`` pointer first; when it is missing, unreadable, or
    points at a torn tag (the crash-mid-checkpoint cases), falls back to
    scanning the tag directories newest-first, warning about every torn tag
    it skips. Returns None when nothing loadable exists."""
    latest = read_latest_tag(load_dir)
    if latest is not None:
        problem = tag_problem(load_dir, latest, need_optim=need_optim,
                              verify=verify)
        if problem is None:
            return latest
        logger.warning(f"'latest' tag '{latest}' in {load_dir} is not "
                       f"loadable ({problem}); scanning for the newest "
                       "complete checkpoint")
    if not os.path.isdir(load_dir):
        return None
    candidates = [d for d in os.listdir(load_dir)
                  if os.path.isdir(os.path.join(load_dir, d)) and d != latest]
    candidates.sort(key=lambda t: _tag_sort_key(load_dir, t), reverse=True)
    for tag in candidates:
        problem = tag_problem(load_dir, tag, need_optim=need_optim,
                              verify=verify)
        if problem is None:
            logger.warning(f"resuming from '{tag}' instead")
            return tag
        if os.path.exists(os.path.join(load_dir, tag, MODEL_FILE)) or \
                os.path.exists(os.path.join(load_dir, tag, MANIFEST_FILE)):
            logger.warning(f"skipping torn checkpoint '{tag}': {problem}")
    return None


# --------------------------------------------------------------------------- #
# save
# --------------------------------------------------------------------------- #

def snapshot_state_flats(state: Dict[str, Any]
                         ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Materialise (model_flat, optim_flat) host copies of an engine state
    tree — the device fetch half of a save, separated so the rolling
    checkpointer can snapshot synchronously and commit in the background.
    ONE policed drain (:func:`drain_to_host`): the copies are queued, then
    one sync; every array owns fresh memory, so the caller may hand the
    flats to background writers while the engine trains on."""
    optim_state = {"opt": state["opt"], "step": state["step"],
                   "scaler": state["scaler"], "skipped": state["skipped"]}
    return drain_to_host(flatten_tree(state["master"]), flatten_tree(optim_state))


def write_checkpoint_files(ckpt_engine, save_dir: str, tag: str,
                           model_flat: Dict[str, np.ndarray],
                           optim_flat: Dict[str, np.ndarray],
                           client_state: Dict[str, Any]
                           ) -> Dict[str, str]:
    """Queue/perform the tag's data writes through ``ckpt_engine`` and write
    the client json. Returns the file table (name -> path) that
    :func:`commit_checkpoint` builds the manifest from — the engine's write
    path computes each file's crc32 table from the arrays the writer was
    GIVEN (on the writer thread for the async engine, so the checksum scan
    stays OFF the step loop), and ``take_checksums`` collects them at
    commit."""
    ckpt_dir = os.path.join(save_dir, tag)
    ckpt_engine.create(tag)
    ckpt_engine.makedirs(ckpt_dir, exist_ok=True)
    files = {MODEL_FILE: os.path.join(ckpt_dir, MODEL_FILE),
             OPTIM_FILE: os.path.join(ckpt_dir, OPTIM_FILE)}
    # ownership passes to the engine: the flats are fresh host copies, so
    # no engine copies them a second time
    ckpt_engine.save(model_flat, files[MODEL_FILE])
    ckpt_engine.save(optim_flat, files[OPTIM_FILE])
    # atomic: tag_problem treats a torn counters file as a torn tag, so a
    # crash mid-dump must leave no half-written client_state.json behind
    client_path = os.path.join(ckpt_dir, CLIENT_FILE)
    tmp = client_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(client_state, f, indent=2, default=str)
    os.replace(tmp, client_path)
    return files


def commit_checkpoint(ckpt_engine, save_dir: str, tag: str,
                      files: Dict[str, str], save_latest: bool = True,
                      monotonic: bool = False) -> None:
    """Durability barrier + ordered metadata: drain the writers (commit),
    then the manifest (completeness marker), then — only then — flip
    ``latest``. A crash at any point leaves either the previous complete
    checkpoint reachable or this one, never a latest pointing at a torn
    tag that a reader cannot detect. ``monotonic`` guards the flip against
    rolling ``latest`` backwards (see :func:`write_latest_tag`)."""
    ckpt_engine.commit(tag)
    checksums = {fname: ckpt_engine.take_checksums(path)
                 for fname, path in files.items()}
    write_manifest(os.path.join(save_dir, tag), tag, checksums)
    if save_latest:
        write_latest_tag(save_dir, tag, monotonic=monotonic)


def save_engine_checkpoint(save_dir: str, tag: str, state: Dict[str, Any],
                           client_state: Dict[str, Any], save_latest: bool = True,
                           ckpt_engine=None, stats=None, snapshot=None) -> None:
    """``ckpt_engine``: a ``checkpoint.engine.CheckpointEngine``; the async
    engine queues the writes and makes them durable at ``commit`` — the
    ``latest`` tag only flips after commit succeeds. ``stats``: an optional
    ``monitor.CheckpointStats`` fed the snapshot/write/commit timings (the
    engine's ``save_checkpoint`` passes its own). ``snapshot``: a callable
    giving (model_flat, optim_flat) in place of
    :func:`snapshot_state_flats` of ``state`` (an offload engine's, which
    adds its host-side state)."""
    if ckpt_engine is None:
        from deepspeed_tpu_torch.checkpoint.engine import NativeCheckpointEngine
        ckpt_engine = NativeCheckpointEngine()
    perf = time.perf_counter
    t0 = perf()
    model_flat, optim_flat = snapshot() if snapshot is not None \
        else snapshot_state_flats(state)
    t1 = perf()
    files = write_checkpoint_files(ckpt_engine, save_dir, tag,
                                   model_flat, optim_flat, client_state)
    t2 = perf()
    commit_checkpoint(ckpt_engine, save_dir, tag, files,
                      save_latest=save_latest)
    t3 = perf()
    if stats is not None:
        stats.record_save(snapshot_s=t1 - t0, write_s=t2 - t1,
                          queue_depth=ckpt_engine.queue_depth())
        stats.record_commit(commit_s=t3 - t2)
        stats.retries = ckpt_engine.retries
    log_dist(f"saved checkpoint {os.path.join(save_dir, tag)}", ranks=[0])


# --------------------------------------------------------------------------- #
# load
# --------------------------------------------------------------------------- #

def resolve_load_tag(load_dir: str, tag: Optional[str],
                     need_optim: bool = True, verify: bool = False) -> str:
    """The tag a load should use. ``tag=None`` resumes: newest complete tag,
    skipping torn ones with warnings. An EXPLICIT tag is honored but checked
    — loading a torn tag raises :class:`CheckpointCorrupt` with the reason
    instead of failing deep inside array parsing."""
    if tag is not None:
        problem = tag_problem(load_dir, tag, need_optim=need_optim,
                              verify=verify)
        if problem is not None:
            raise CheckpointCorrupt(
                f"checkpoint tag '{tag}' in {load_dir} is not loadable: "
                f"{problem}")
        return tag
    found = find_resume_tag(load_dir, need_optim=need_optim, verify=verify)
    if found is None:
        raise FileNotFoundError(
            f"no loadable checkpoint in {load_dir}: no 'latest' file and no "
            "complete tag directory; pass an explicit tag")
    return found


def _load_verified(ckpt_engine, ckpt_dir: str, fname: str,
                   verify: bool) -> Tuple[Dict[str, np.ndarray], float, float]:
    """(flat, read seconds, verify seconds)."""
    t0 = time.perf_counter()
    flat = ckpt_engine.load(os.path.join(ckpt_dir, fname))
    t1 = time.perf_counter()
    if verify:
        bad = verify_flat(flat, read_manifest(ckpt_dir), fname)
        if bad:
            raise CheckpointCorrupt(
                f"checksum mismatch loading {os.path.join(ckpt_dir, fname)}: "
                f"arrays {bad[:4]}{'...' if len(bad) > 4 else ''}")
    return flat, t1 - t0, time.perf_counter() - t1


def load_engine_checkpoint(load_dir: str, tag: Optional[str], state: Dict[str, Any],
                           load_optimizer_states: bool = True,
                           load_module_only: bool = False, ckpt_engine=None,
                           verify: bool = False, stats=None, host_loader=None
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a tag INTO ``state``'s live tensors (see the module docstring)
    and return ``(state, client_state)``. ``stats``: an optional
    ``monitor.CheckpointStats`` fed the read/verify/host->device timings.
    ``host_loader(model_flat, optim_flat or None)``: an offload engine's
    load of the leaves ``state`` does not hold (its host-flow master and
    moments), run after the device leaves landed."""
    if ckpt_engine is None:
        from deepspeed_tpu_torch.checkpoint.engine import NativeCheckpointEngine
        ckpt_engine = NativeCheckpointEngine()
    need_optim = load_optimizer_states and not load_module_only
    # the checksum pass runs ONCE per file: an EXPLICIT tag resolves
    # structurally and verifies in _load_verified on the arrays it already
    # loaded; a tag=None SCAN verifies candidates inside find_resume_tag
    # instead — a checksum-corrupt newest tag must fall back to an older
    # complete one, not surface after selection — and skips the redundant
    # re-verify at load
    scan_verify = verify and tag is None
    tag = resolve_load_tag(load_dir, tag, need_optim=need_optim,
                           verify=scan_verify)
    ckpt_dir = os.path.join(load_dir, tag)
    verify = verify and not scan_verify

    model_flat, read_s, verify_s = _load_verified(ckpt_engine, ckpt_dir, MODEL_FILE,
                                                  verify)
    plan = copy_plan(state["master"], model_flat)
    if need_optim:
        optim_flat, r, v = _load_verified(ckpt_engine, ckpt_dir, OPTIM_FILE, verify)
        read_s, verify_s = read_s + r, verify_s + v
        plan += copy_plan({"opt": state["opt"], "step": state["step"],
                           "scaler": state["scaler"], "skipped": state["skipped"]},
                          optim_flat)
    t0 = time.perf_counter()
    load_into(state, plan)
    if host_loader is not None:
        host_loader(model_flat, optim_flat if need_optim else None)
    h2d_s = time.perf_counter() - t0

    client_path = os.path.join(ckpt_dir, CLIENT_FILE)
    client_state = {}
    if os.path.exists(client_path):
        with open(client_path) as f:
            client_state = json.load(f)
    if stats is not None:
        stats.record_load(read_s=read_s, verify_s=verify_s, h2d_s=h2d_s)
    log_dist(f"loaded checkpoint {ckpt_dir}", ranks=[0])
    return state, client_state
