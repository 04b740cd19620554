"""Float64 scipy/numpy oracle implementation of the forward models.

The port's own copy of ``metrotrpl_tpu/oracle/``: the comparison
implementation of the tests and the source of the synthetic data that
``write-example`` writes. It implements the same mathematics as the
reference's ``forward_solver.py`` solve path: LSODA stiff integration of
the 1D drift-diffusion-recombination model with TRPL/TRTS observables.
"""

from metrotrpl_tpu_torch.oracle.scipy_reference import (  # noqa: F401
    dydt_std,
    dydt_traps,
    efield_init,
    solve_reference,
    calculate_pl,
    calculate_trts,
)
