"""Physical constants and framework-wide defaults.

Values match the reference implementation (reference forward_solver.py:18-24,
sim_utils.py:13-23) so that simulated observables agree numerically.
Copy of ``metrotrpl_tpu/constants.py``.
"""

# Vacuum permittivity, converted from [C / (V m)] to [C / (V nm)]
eps0 = 8.854e-12 * 1e-9
# Elementary charge in units of e
q = 1.0
# Elementary charge in Coulombs
q_C = 1.602e-19
# Boltzmann constant [eV / K]
kB = 8.61773e-5

# Default stiff-solver tolerances of the reference (forward_solver.py:18-19).
# Used by the scipy oracle; the TPU stepper uses a fixed grid derived from hmax.
DEFAULT_RTOL = 1e-7
DEFAULT_ATOL = 1e-10
# Default maximum solver step [ns] (sim_utils.py:17)
DEFAULT_HMAX = 4

# Parallel-tempering swap attempt interval (sim_utils.py:19)
DEFAULT_TEMPER_FREQ = 10
# Max retries for in-bounds trial move proposals (sim_utils.py:20)
MAX_PROPOSALS = 100
# Fraction of negative post-convolution values tolerated before a simulation
# is declared failed (sim_utils.py:21-23)
NEGATIVE_FRAC_TOL = 0.2

# Status-log interval in MH iterations (metropolis.py:31-32)
MSG_FREQ = 100
MSG_COOLDOWN = 3
