"""metrotrpl_tpu_torch — the PyTorch + CUDA port of ``metrotrpl_tpu``.

Bayesian inference of semiconductor carrier parameters from TRPL decay
curves: a tempered Metropolis-Hastings walk whose every proposal costs one
stiff 1-D drift-diffusion PDE solve per measurement. The JAX package
``metrotrpl_tpu`` stays the reference; this package mirrors its layout
module for module and imports ``torch``, never ``jax``.

The hot loop — the whole fixed-step SDIRK integration of a batch of
simulations — is one hand-written CUDA kernel
(``solver/csrc/sdirk_solve.cu``), built with ``nvcc`` at first use. Every
kernel wrapper runs its plain PyTorch version for CPU tensors, so the CPU
tests exercise the same code paths.
"""

import math

import torch

__version__ = "0.1.0"


def resolve_device(device):
    """``torch.device`` for ``device`` (a string or device). Asking for
    CUDA where no CUDA device exists raises: the port never falls back to
    the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def default_walk_dtype(device):
    """The walk dtype policy of ``metrotrpl_tpu.inference.metro``: float32
    on the accelerator, float64 on the CPU where it costs little."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


_LN10 = math.log(10.0)


def pow10(x):
    """``10 ** x`` elementwise, each element's value independent of the
    tensor it sits in. On the CPU ``torch.pow`` computes the SIMD body of
    a tensor (Sleef) and its last few elements (libm) with different
    code, so one element's ``10 ** x`` could move by an ulp with the
    batch's size, and a walk with it; ``torch.exp`` runs its tail through
    the vector code too. Every per-row ``10 **`` of the walk goes through
    here."""
    return torch.exp(x * _LN10)
