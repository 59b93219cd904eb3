"""Checkpointing (the JAX package's ``checkpoint/``: engine save/load with
manifests and torn-tag resume, sync and async checkpoint engines, rolling
saves, sharded and universal formats) and the weight carrier between the
JAX package's parameter tree and the port (``convert``). Checkpoint files
are the JAX package's byte format and move both ways."""

from deepspeed_tpu_torch.checkpoint.convert import params_from_flat, params_to_flat
from deepspeed_tpu_torch.checkpoint.state import (
    CheckpointCorrupt,
    save_engine_checkpoint,
    load_engine_checkpoint,
    read_latest_tag,
    find_resume_tag,
    resolve_load_tag,
    tag_problem,
    flatten_tree,
    unflatten_into,
)
from deepspeed_tpu_torch.checkpoint.rolling import RollingCheckpointer
from deepspeed_tpu_torch.checkpoint.engine import (
    CheckpointEngine,
    NativeCheckpointEngine,
    AsyncCheckpointEngine,
    build_checkpoint_engine,
)
from deepspeed_tpu_torch.checkpoint.sharded import save_sharded, load_sharded
from deepspeed_tpu_torch.checkpoint.universal import (
    ds_to_universal,
    load_universal,
    load_universal_into_engine,
)
