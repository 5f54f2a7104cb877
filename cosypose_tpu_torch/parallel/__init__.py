"""Data parallelism over ranks (port of cosypose_tpu/parallel/). Left out:
`make_mesh` and `fsdp_shardings`; the JAX device mesh and its shardings are
replaced by `ddp.DataParallel` over torch.distributed, with FSDP2 for the
sharded parameter mode."""

from .ddp import (PARAM_MODES, DataParallel, gather_to_host, mean_over_ranks, rank_rows,
                  replicate, shard_batch)
