"""Offline consolidation of engine checkpoints into a plain fp32 state dict
(the JAX package's ``utils/zero_to_fp32.py``).

The script users run to turn a checkpoint into something
``model.load_state_dict`` accepts, with no accelerator required. Tags hold
full logical tensors, so consolidation is reading the model file and
re-keying. The CLI::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <output> [-t TAG]

A ``.pt``/``.bin`` output is a torch state dict with dotted keys
(``h_0.attn.c_attn.kernel``); anything else is an npz with the ``/``-joined
keys.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.state import MODEL_FILE, read_latest_tag
from deepspeed_tpu_torch.utils.logging import logger


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """Full fp32 param dict, keys '/'-joined."""
    tag = tag or read_latest_tag(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(
            f"no 'latest' file in {checkpoint_dir}; pass an explicit tag")
    with np.load(os.path.join(checkpoint_dir, tag, MODEL_FILE)) as data:
        return {k: np.asarray(v, np.float32) for k, v in data.items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None) -> str:
    """Write the consolidated state dict and return the path written.

    ``.pt``/``.bin`` -> torch.save of a torch state dict (dots for key
    separators, the HF/torch convention); anything else -> npz, with
    ``.npz`` appended to a name that lacks it.
    """
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    if output_file.endswith(".pt") or output_file.endswith(".bin"):
        torch_sd = {k.replace("/", "."): torch.from_numpy(np.array(v))
                    for k, v in sd.items()}
        torch.save(torch_sd, output_file)
    else:
        if not output_file.endswith(".npz"):
            output_file += ".npz"
        np.savez(output_file, **sd)
    logger.info(f"consolidated fp32 state dict ({len(sd)} tensors) -> {output_file}")
    return output_file


def main():
    p = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint into an fp32 state dict")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file",
                   help=".pt/.bin -> torch state dict; otherwise .npz")
    p.add_argument("-t", "--tag", default=None)
    args = p.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
