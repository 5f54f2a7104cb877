"""Multi-process smoke check (port of cosypose_tpu/scripts/example_multichip.py):
print this rank and the world, all-reduce each rank's rows of an arange and
check the sum.

  python -m torch.distributed.run --nproc_per_node N \\
      -m cosypose_tpu_torch.scripts.example_multichip [--device cpu] [--dist-backend gloo]

Alone (no torchrun) it runs as one process.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from ..utils.distributed import distributed_mode, get_rank, get_world_size
from ..utils.logging import get_logger

logger = get_logger(__name__)


def main(argv=None) -> float:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--dist-backend", default=None,
                        help="default: nccl on cuda, gloo on cpu")
    args = parser.parse_args(argv)
    with distributed_mode(args.dist_backend, args.device) as device:
        rank, world = get_rank(), get_world_size()
        backend = dist.get_backend() if dist.is_initialized() else "none"
        logger.info(f"process {rank}/{world} on {device}, backend {backend}")
        rows = torch.arange(world * 4, dtype=torch.float32, device=device)[4 * rank:4 * rank + 4]
        total = rows.sum()
        if world > 1:
            dist.all_reduce(total)
        total, expected = float(total), float(sum(range(world * 4)))
        if abs(total - expected) > 1e-3:
            raise AssertionError(f"all-reduce over {world} ranks gave {total}, want {expected}")
        logger.info(f"all-reduce over {world} ranks ok: {total}")
        return total


if __name__ == "__main__":
    main()
