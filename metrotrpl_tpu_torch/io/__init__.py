"""Run-state IO: history/ensemble containers, checkpoints, logging.

The port's own copy of ``metrotrpl_tpu/io/``. Checkpoints from either
package load in the other: both write the classes as ``sim_utils.*``."""

from metrotrpl_tpu_torch.io.ensemble import Ensemble, History  # noqa: F401
from metrotrpl_tpu_torch.io.logging import start_logging, stop_logging  # noqa: F401
