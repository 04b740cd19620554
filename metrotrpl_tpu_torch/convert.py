"""Parameter carry-over from the JAX package.

This system's parameters are the host-side plans built from a config and
its data, and, for the ``nn`` likelihood kind, the surrogate's weights.
:func:`from_reference_plan` turns the JAX package's plans into the
port's and :func:`from_reference_nn` its surrogate into the port's
module, so both packages can be fed identical plans; the tensors are
made on the walk's device by ``make_eval_logll(plan, device=...)`` and
``build_mh_kernel``.
"""

import numpy as np

from metrotrpl_tpu_torch import resolve_device
from metrotrpl_tpu_torch.inference.likelihood import LikelihoodPlan
from metrotrpl_tpu_torch.inference.moves import MovePlan
from metrotrpl_tpu_torch.solver.forward import ForwardPlan
from metrotrpl_tpu_torch.surrogate import NeuralNetwork


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def _convert_tuple(src, cls):
    """Field-for-field copy of a NamedTuple into ``cls``; raises if the
    two disagree on their fields."""
    if tuple(src._fields) != tuple(cls._fields):
        raise ValueError(f"{type(src).__name__} fields {src._fields} do not "
                         f"match {cls.__name__} fields {cls._fields}")
    return cls(*(_copy(v) for v in src))


def _forward_plan(fp):
    return None if fp is None else _convert_tuple(fp, ForwardPlan)


def from_reference_nn(jax_nn, device="cuda"):
    """The port's surrogate module from a JAX ``NeuralNetwork``: its
    (kernel, bias) pairs, in their dtype, and its ``model_scales``, on
    ``device``."""
    net = NeuralNetwork()
    net.set_params([(np.asarray(k), np.asarray(b)) for k, b in jax_nn.params])
    net.set_scales(jax_nn.model_scales)
    net.has_model = jax_nn.has_model
    return net.to(resolve_device(device))


def from_reference_plan(like_plan, move_plan=None):
    """Port plans from a JAX ``LikelihoodPlan`` of any kind (with its
    ``ForwardPlan`` groups, or its surrogate, kept on the CPU) and
    optionally a JAX ``MovePlan``. Returns the port's LikelihoodPlan, or
    (LikelihoodPlan, MovePlan) when ``move_plan`` is given."""
    fields = {f: _copy(getattr(like_plan, f)) for f in like_plan._fields}
    if like_plan.fwd is not None:
        fields["fwd"] = tuple((np.array(idx, copy=True), _forward_plan(fp),
                               _forward_plan(fp_hi))
                              for idx, fp, fp_hi in like_plan.fwd)
    if like_plan.nn is not None:
        fields["nn"] = from_reference_nn(like_plan.nn, device="cpu")
    fields["param_idx"] = dict(like_plan.param_idx)
    out = LikelihoodPlan(**fields)
    if move_plan is None:
        return out
    return out, _convert_tuple(move_plan, MovePlan)
