"""Console logging with the time since start and, in a data-parallel run,
the rank (port of cosypose_tpu/utils/logging.py)."""

from __future__ import annotations

import logging
import time

import torch.distributed as dist

_START = time.time()


class _ElapsedFormatter(logging.Formatter):
    def format(self, record):
        elapsed = time.time() - _START
        record.elapsed = f"{int(elapsed // 60):02d}:{elapsed % 60:06.3f}"
        world = dist.get_world_size() if dist.is_initialized() else 1
        record.rank = f" rank {dist.get_rank()}/{world}" if world > 1 else ""
        return super().format(record)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            _ElapsedFormatter("[%(elapsed)s%(rank)s] %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
