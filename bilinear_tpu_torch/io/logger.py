"""Run logging with the reference's artifact contract (the port's copy of
``bilinear_tpu/io/logger.py``): run dir ``{save_root}/{comment}/``, log file
``debug.log`` there plus the console, both at DEBUG with the format
``[LEVEL|file:line] time > message``."""
from __future__ import annotations

import logging
import os
from datetime import datetime
from typing import Optional, Tuple

FORMAT = "[%(levelname)s|%(filename)s:%(lineno)s] %(asctime)s > %(message)s"


def get_logger(comment: Optional[str] = None, save_root: str = "save",
               quiet: bool = False) -> Tuple[logging.Logger, str, str]:
    """``quiet=True`` (a data-parallel run's ranks but the first): the run
    dir's names and a logger that writes nowhere."""
    if comment is None:
        comment = datetime.now().strftime("%b%d_%H-%M-%S")
    log_dir = os.path.join(save_root, comment)
    if quiet:
        logger = logging.getLogger("bilinear_tpu_torch.quiet")
        logger.propagate = False
        if not logger.handlers:
            logger.addHandler(logging.NullHandler())
        return logger, log_dir, comment
    os.makedirs(log_dir, exist_ok=True)

    formatter = logging.Formatter(FORMAT)
    logger = logging.getLogger("bilinear_tpu_torch")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    # One file handler per run dir; a second call for another dir in the
    # same process moves the file handler there.
    wanted = os.path.abspath(os.path.join(log_dir, "debug.log"))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename != wanted:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        fh = logging.FileHandler(wanted)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger, log_dir, comment
