from .ddp import (PARAM_MODES, DataParallel, gather_to_host, mean_over_ranks, rank_rows,
                  replicate, shard_batch)
