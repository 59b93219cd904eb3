"""``ds_elastic`` CLI: inspect elastic configs.

Parity: reference ``bin/ds_elastic`` — given a DeepSpeed config with an
``elasticity`` block, print the resolved final batch size, compatible world
sizes, and the micro-batch/GAS split at a hypothetical world size.
"""

from __future__ import annotations

import argparse
import json

from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config


def main():
    p = argparse.ArgumentParser(description="deepspeed_tpu_torch elasticity inspector")
    p.add_argument("-c", "--config", required=True, help="config json path")
    p.add_argument("-w", "--world-size", type=int, default=0,
                   help="resolve micro-batch/GAS at this world size")
    args = p.parse_args()
    with open(args.config) as f:
        ds_config = json.load(f)
    if args.world_size:
        final, valid, micro = compute_elastic_config(
            ds_config, world_size=args.world_size, return_microbatch=True)
        gas = final // (micro * args.world_size)
        print(json.dumps({"final_batch_size": final,
                          "valid_world_sizes": valid,
                          "world_size": args.world_size,
                          "micro_batch": micro,
                          "gradient_accumulation_steps": gas}, indent=2))
    else:
        final, valid = compute_elastic_config(ds_config)
        print(json.dumps({"final_batch_size": final,
                          "valid_world_sizes": valid}, indent=2))


if __name__ == "__main__":
    main()
