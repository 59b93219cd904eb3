"""Rank-aware logging (the JAX package's ``utils/logging.py``): ``logger``,
``log_dist`` and ``LoggerFactory``. The logger is ``deepspeed_tpu_torch``,
the one every module of the port logs to; a rank is the
``torch.distributed`` rank where a process group is up, else ``RANK``."""

import functools
import logging
import os
import sys
from typing import List, Optional

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:

    @staticmethod
    def create_logger(name: str = "deepspeed_tpu_torch", level=logging.INFO) -> logging.Logger:
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        lg = logging.getLogger(name)
        lg.setLevel(level)
        lg.propagate = False
        if not lg.handlers:
            handler = logging.StreamHandler(stream=sys.stdout)
            handler.setLevel(level)
            handler.setFormatter(formatter)
            lg.addHandler(handler)
        return lg


logger = LoggerFactory.create_logger(
    level=log_levels.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO))


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


@functools.lru_cache(None)
def _warn_once(msg: str):
    logger.warning(msg)


def warning_once(msg: str):
    _warn_once(msg)


def log_dist(message: str, ranks: Optional[List[int]] = None, level: int = logging.INFO):
    """Log only on the given ranks (None or [-1] -> all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message: str):
    if _process_index() == 0:
        logger.info(message)
