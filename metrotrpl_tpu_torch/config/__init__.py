"""Configuration and data IO layer.

Parses/writes the reference's 4-section MCMC config-script text format and the
CSV measurement / initial-condition files, producing the same dict structures
(``grid``, ``param_info``, ``meas_flags``, ``MCMC_fields``) the rest of the
framework consumes (reference format: bayes_io.py:259-966).

The port's own copy of ``metrotrpl_tpu/config/`` (the port imports nothing
of the JAX package); the tests hold its parsed dicts equal to the JAX
reader's.
"""

from metrotrpl_tpu_torch.config.script_io import (  # noqa: F401
    read_config_script_file,
    parse_config_script_file,
    generate_config_script_file,
    finalize_config,
    insert_param,
    remap_fittable_inds,
    remap_constraint_grps,
)
from metrotrpl_tpu_torch.config.native import (  # noqa: F401
    read_config_toml,
    parse_config_toml,
    write_config_toml,
)


from metrotrpl_tpu_torch.config.data_io import (  # noqa: F401
    get_data,
    get_initpoints,
    make_dir,
)
from metrotrpl_tpu_torch.config.validate import (  # noqa: F401
    validate_grid,
    validate_param_info,
    validate_meas_flags,
    validate_MCMC_fields,
)


def read_config(path):
    """Format-dispatching reader: ``.toml`` -> the native TOML format,
    anything else -> the reference text format."""
    if str(path).endswith(".toml"):
        return read_config_toml(path)
    return read_config_script_file(path)


def parse_config(path):
    """Format-dispatching RAW parser (no finalize pipeline): the
    pre-validation dicts the config writers expect, so that
    parse -> write round-trips losslessly (used by convert-config)."""
    if str(path).endswith(".toml"):
        return parse_config_toml(path)
    return parse_config_script_file(path)

