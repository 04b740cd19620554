"""Run logging (reference mcmc_logging.py equivalent): timestamped per-run
log files plus console echo, DEBUG level when verbose.

The console echo is an intentional improvement over the reference (which
attaches only a FileHandler, mcmc_logging.py:27 — its terminal stays
silent for the whole run): progress lines also stream to stderr.
"""

import logging
import os
from datetime import datetime


def start_logging(log_dir=".", name="Ensemble0", verbose=False):
    """Create a logger writing to <log_dir>/<name><timestamp>.log and
    echoing to the console."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    logger = logging.getLogger(f"metrotrpl.{name}.{stamp}")
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    handler = logging.FileHandler(
        os.path.join(log_dir, f"{name}{stamp}.log"), mode="a")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(handler)
    echo = logging.StreamHandler()
    echo.setFormatter(logging.Formatter("%(levelname)s - %(message)s"))
    logger.addHandler(echo)
    return logger, handler


def stop_logging(logger, handler, err_code=0):
    if err_code:
        logger.error(f"Termination with error code {err_code}")
    handler.close()
    for h in list(logger.handlers):
        logger.removeHandler(h)
