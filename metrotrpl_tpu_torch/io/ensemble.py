"""Walk history and ensemble run-state containers.

Output-compatible with the reference's pickled ``Ensemble``/``History``
(reference sim_utils.py:25-201): the same attribute layout (``H.states``
(n_chains, n_params, n_iters), ``H.accept``, ``H.loglikelihood``,
``mean_<param>`` views, ``ensemble_fields``/``unique_fields`` dicts), and a
pickle writer that emits objects the reference GUI can unpickle directly
(class paths spoofed to ``sim_utils.Ensemble``/``sim_utils.History``).

Checkpoints are plain .pik pickles of these containers — bit-exact resume is
guaranteed by the keyed-RNG design (iteration k's randomness is
fold_in(seed, k), so no generator state needs saving; the seed is stored in
``ensemble_fields['_rng_seed']``).
"""

import copy
import pickle

import numpy as np


class History:
    """Record of past states of the walk (reference sim_utils.py:25-74)."""

    def __init__(self, n_chains, num_iters, names):
        self.states_are_one_array = True
        self.states = np.zeros((n_chains, len(names), num_iters))
        self.accept = np.zeros((n_chains, num_iters), dtype=int)
        self.loglikelihood = np.zeros((n_chains, num_iters))
        self.swap_attempts = np.zeros(n_chains, dtype=int)
        self.swap_accept = np.zeros(n_chains, dtype=int)

    def update(self, names):
        """Attach mean_<param> per-parameter views (GUI contract)."""
        for i, param in enumerate(names):
            setattr(self, f"mean_{param}", self.states[:, i])

    def pack(self, states, logll, accept):
        self.states = states
        self.loglikelihood = logll
        self.accept = accept

    def truncate(self, k):
        self.states = self.states[:, :, :k]
        self.accept = self.accept[:, :k]
        self.loglikelihood = self.loglikelihood[:, :k]

    def extend(self, new_num_iters):
        cur = self.accept.shape[1]
        if new_num_iters < cur:
            self.truncate(new_num_iters)
            return
        if new_num_iters == cur:
            return
        extra = new_num_iters - cur
        self.accept = np.concatenate(
            [self.accept,
             np.zeros((self.accept.shape[0], extra), dtype=self.accept.dtype)],
            axis=1)
        self.loglikelihood = np.concatenate(
            [self.loglikelihood,
             np.zeros((self.loglikelihood.shape[0], extra),
                      dtype=self.loglikelihood.dtype)], axis=1)
        self.states = np.concatenate(
            [self.states,
             np.zeros(self.states.shape[:2] + (extra,),
                      dtype=self.states.dtype)], axis=2)


class Ensemble:
    """Checkpointable ensemble run state.

    ensemble_fields : settings + data shared across chains
    unique_fields : list of per-chain dicts (chiefly the temperature _T)
    """

    def __init__(self, param_info, sim_info, MCMC_fields, num_iters,
                 verbose=False):
        MCMC_fields = dict(MCMC_fields)
        param_info = copy.deepcopy(param_info)
        ef = {}
        for field in ("output_path", "init_cond_path", "measurement_path",
                      "checkpoint_freq", "ini_mode", "solver", "model",
                      "num_iters", "log_y"):
            ef[field] = MCMC_fields.pop(field)
        for field in ("rtol", "atol", "scale_factor", "load_checkpoint",
                      "fittable_fluences", "fittable_absps",
                      "irf_convolution"):
            ef[field] = MCMC_fields.pop(field, None)
        # both config readers place mu_constraint in param_info (the
        # reference vocabulary); accept either home so the checkpoint
        # retains it
        ef["do_mu_constraint"] = param_info.pop(
            "do_mu_constraint", MCMC_fields.pop("do_mu_constraint", None))
        ef["temper_freq"] = MCMC_fields.pop("temper_freq", 10)
        if "model_uncertainty" in MCMC_fields and "likel2move_ratio" in MCMC_fields:
            MCMC_fields.pop("likel2move_ratio")
        if "likel2move_ratio" in MCMC_fields:
            ef["likel2move_ratio"] = MCMC_fields.pop("likel2move_ratio")
        ef["hard_bounds"] = MCMC_fields.pop("hard_bounds", 0)
        ef["hmax"] = MCMC_fields.pop("hmax", 4)
        ef["force_min_y"] = MCMC_fields.pop("force_min_y", 0)

        names = param_info.pop("names")
        ef["prior_dist"] = param_info.pop("prior_dist")
        do_log = param_info.pop("do_log")
        ef["do_log"] = np.array([do_log[p] for p in names], dtype=bool)
        trial_move = param_info.pop("trial_move")
        active = param_info.pop("active")
        ef["base_trial_move"] = np.array(
            [trial_move[p] if active[p] else 0 for p in names], dtype=float)
        ef["active"] = np.array([active[p] for p in names], dtype=bool)
        units = param_info.pop("unit_conversions")
        ef["units"] = np.array([units.get(p, 1) for p in names], dtype=float)
        ef["_param_indexes"] = {n: i for i, n in enumerate(names)}
        ef["_T"] = list(MCMC_fields.pop("parallel_tempering", [1]))
        ef["_n_chains"] = len(ef["_T"])
        ef["names"] = names
        ef["do_parallel_tempering"] = ef["_n_chains"] > 1
        ef["_sim_info"] = sim_info

        init_state = np.array(
            [param_info["init_guess"][p] for p in names], dtype=float)
        self.H = History(ef["_n_chains"], num_iters, names)
        self.H.states[:, :, 0] = init_state

        self.unique_fields = []
        for i in range(ef["_n_chains"]):
            uf = dict(MCMC_fields)
            uf["_T"] = ef["_T"][i]
            if "likel2move_ratio" in ef:
                l2v = ef["likel2move_ratio"]
                if not isinstance(l2v, dict):  # validated scalar form
                    l2v = {m: l2v for m in sim_info["meas_types"]}
                missing = set(sim_info["meas_types"]) - set(l2v)
                if missing:
                    raise ValueError(
                        "likel2move_ratio missing measurement type(s) "
                        f"{sorted(missing)}: provide one value per type in "
                        f"{sorted(set(sim_info['meas_types']))}")
                uf["model_uncertainty"] = {
                    m: max(ef["base_trial_move"]) * l2v[m]
                    for m in sim_info["meas_types"]}
            self.unique_fields.append(uf)

        self.ensemble_fields = ef
        self.latest_iter = 0
        self.random_state = None

    def checkpoint(self, fname, gui_compat=True):
        """Pickle the ensemble. With gui_compat the emitted stream
        references ONLY ``sim_utils.Ensemble`` / ``sim_utils.History``
        globals plus stdlib reconstructors — no ``metrotrpl_tpu`` names —
        so a plain ``pickle.load`` in the reference's own environment
        (GUI/window.py:250-266) works without this package installed."""
        self.H.update(self.ensemble_fields["names"])
        with open(fname, "wb+") as f:
            if gui_compat:
                _dump_gui_compat(self, f)
            else:
                pickle.dump(self, f)


# Stand-in classes whose pickled GLOBAL path is sim_utils.<name>; at load
# time they resolve to whatever class lives there (the reference's real
# containers, or load_checkpoint's shim mapping back to ours).
_REF_SHIMS = {}


def _ref_shim(name):
    cls = _REF_SHIMS.get(name)
    if cls is None:
        cls = type(name, (), {})
        cls.__module__ = "sim_utils"
        cls.__qualname__ = name
        _REF_SHIMS[name] = cls
    return cls


class _CompatPickler(pickle.Pickler):
    """Pickler renaming our container classes to the reference's module
    path via stdlib-only reduces (copyreg._reconstructor + a GLOBAL
    sim_utils.<name> reference), so the stream is loadable by plain
    pickle in an environment without this package."""

    # keyed on this module's own name, so the port's classes, too, are
    # written as sim_utils.<name> and the stream loads in either package
    _RENAME = {
        (__name__, "Ensemble"): "Ensemble",
        (__name__, "History"): "History",
    }

    def reducer_override(self, obj):
        import copyreg

        cls = type(obj)
        name = self._RENAME.get((cls.__module__, cls.__name__))
        if name is not None:
            return (copyreg._reconstructor,
                    (_ref_shim(name), object, None), dict(obj.__dict__))
        return NotImplemented


def _dump_gui_compat(obj, f):
    """Dump with sim_utils-global class names. pickle's save_global
    verifies the class is importable at dump time, so a shim sim_utils
    module exposing the stand-in classes is installed for the duration."""
    import sys
    import types

    shim = None
    if "sim_utils" not in sys.modules:
        shim = types.ModuleType("sim_utils")
        shim.Ensemble = _ref_shim("Ensemble")
        shim.History = _ref_shim("History")
        sys.modules["sim_utils"] = shim
    try:
        _CompatPickler(f).dump(obj)
    finally:
        if shim is not None:
            del sys.modules["sim_utils"]


def load_checkpoint(fname):
    """Load a checkpoint written by us or by the reference.

    Reference pickles reference classes from a top-level ``sim_utils``
    module; a shim mapping is installed during load so those resolve to our
    containers.
    """
    import sys
    import types

    shim = None
    if "sim_utils" not in sys.modules:
        shim = types.ModuleType("sim_utils")
        shim.Ensemble = Ensemble
        shim.History = History

        class _Deprecated:  # MetroState/Parameters/Covariance/Solution shells
            def __init__(self, *a, **k):
                pass
        for n in ("MetroState", "Parameters", "Covariance", "Solution",
                  "EnsembleTemplate"):
            setattr(shim, n, type(n, (_Deprecated,), {}))
        sys.modules["sim_utils"] = shim
    try:
        with open(fname, "rb") as f:
            obj = pickle.load(f)
    finally:
        if shim is not None:
            del sys.modules["sim_utils"]
    # rebind to our classes if the pickle carried reference-class instances
    if not isinstance(obj, Ensemble):
        wrapped = Ensemble.__new__(Ensemble)
        wrapped.__dict__.update(obj.__dict__)
        H = History.__new__(History)
        H.__dict__.update(obj.H.__dict__)
        wrapped.H = H
        obj = wrapped
    return obj
