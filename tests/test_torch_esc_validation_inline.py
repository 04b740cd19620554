"""scripts/esc_validation_torch.py's inline evaluation (the escalation
ladder inline) in float64 against the JAX XLA path's escalate="inline" at
nx=32 (its own file: each JAX compile of the evaluation takes ~20 s on a
CPU)."""

from test_torch_esc_validation import (  # noqa: F401 (the fixture)
    compare_float64_evaluation,
    jax_esc,
)


def test_inline_float64_evaluation_equals_the_jax_xla_path(jax_esc):
    compare_float64_evaluation(jax_esc, escalate=True)
