"""Per-process sharded checkpoint writes (the JAX package's
``checkpoint/sharded.py``), in the same on-disk layout.

The JAX package writes, from each host, the shards of every global array
that the host owns, plus one shared index. The port trains on one device,
so every tensor is one shard at start 0, owned by this process (its
``torch.distributed`` rank, else ``RANK``, else 0). The reader takes
ANY index, including one the JAX package wrote from a multi-device mesh:
it reassembles each tensor host-side from its shards, then places it on
the requested device.

Layout::

    <ckpt_dir>/
      index.json                 {"<ns>/<ns>/<path>": {shape, dtype, shards: [{file, entry, start}]}}
      shards_h<proc>.npz         this process's shard data
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.state import drain_to_host, flatten_tree, unflatten_into
from deepspeed_tpu_torch.utils.logging import _process_index, log_dist

INDEX_FILE = "index.json"


def save_sharded(ckpt_dir: str, trees: Dict[str, Any],
                 process_index: Optional[int] = None) -> None:
    """Write every leaf of ``trees`` as one shard at start 0.

    ``trees`` maps a namespace (e.g. "model", "optim") to a tree of tensors
    (or arrays). The leaves leave the device in one policed drain. Process 0
    writes the index.
    """
    pid = _process_index() if process_index is None else process_index
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    for ns, tree in trees.items():
        # the JAX package's index key: the namespace, then the key path
        # that already starts with it ("model/model/w")
        flat.update({ns + "/" + k: v for k, v in flatten_tree(tree, prefix=ns + "/").items()})
    (host,) = drain_to_host(flat)
    index: Dict[str, dict] = {}
    payload: Dict[str, np.ndarray] = {}
    for i, (key, arr) in enumerate(host.items()):
        entry = f"e{i}"
        index[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "shards": [{"start": [0] * arr.ndim,
                                  "file": f"shards_h{pid}.npz", "entry": entry}]}
        payload[entry] = arr
    from deepspeed_tpu_torch.checkpoint.engine import _atomic_savez
    _atomic_savez(os.path.join(ckpt_dir, f"shards_h{pid}.npz"), payload)
    if pid == 0:
        # write-then-rename: a crash mid-dump must not leave a torn index
        tmp = os.path.join(ckpt_dir, INDEX_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f)
        os.replace(tmp, os.path.join(ckpt_dir, INDEX_FILE))
    log_dist(f"sharded checkpoint written to {ckpt_dir}", ranks=[0])


def load_sharded(ckpt_dir: str, templates: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Reassemble trees from a sharded checkpoint onto ``device`` (default:
    the CUDA device, raising where there is none).

    ``templates`` mirror the namespaces passed to :func:`save_sharded`: trees
    whose leaves carry the shapes (tensors, arrays). Each leaf is built
    host-side from its shard records, whatever mesh wrote them, then copied
    to ``device`` as a new tensor of the index's dtype.
    """
    from deepspeed_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    with open(os.path.join(ckpt_dir, INDEX_FILE)) as f:
        index = json.load(f)
    files: Dict[str, Any] = {}

    def file_data(fname):
        if fname not in files:
            files[fname] = np.load(os.path.join(ckpt_dir, fname))
        return files[fname]

    out: Dict[str, Any] = {}
    try:
        for ns, template in templates.items():
            rebuilt = {}
            for key in flatten_tree(template, prefix=ns + "/"):
                meta = index[ns + "/" + key]
                full = np.empty(tuple(meta["shape"]), np.dtype(meta["dtype"]))
                for srec in meta["shards"]:
                    data = file_data(srec["file"])[srec["entry"]]
                    sl = tuple(slice(s, s + d) for s, d in zip(srec["start"], data.shape))
                    full[sl] = data
                rebuilt[key[len(ns) + 1:]] = torch.from_numpy(full).to(device)
            out[ns] = unflatten_into(template, rebuilt)
    finally:
        for data in files.values():
            data.close()
    return out
