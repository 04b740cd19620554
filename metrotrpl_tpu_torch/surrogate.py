"""Neural-network surrogate forward model (the JAX package's
``surrogate.py``).

An MLP maps (material parameters, excitation, thickness) to
multi-exponential decay coefficients; the TRPL curve is the multiexp
evaluated at the requested delay times (reference nn_features.py:6-91).
Inputs are log10-scaled to (-0.5, 0.5) by stored scale rows; outputs are
unscaled and split into rates and coefficients.

Weights load from an .npz of (``kernel{i}``, ``bias{i}``) pairs or, where
h5py is installed, from a keras .h5 file of Dense layers. The products
are ``nn.Linear`` layers: the JAX package computes them outside any
Pallas kernel.
"""

import numpy as np
import torch
from torch import nn

from metrotrpl_tpu_torch import pow10


class NeuralNetwork(nn.Module):
    """Counterpart of the JAX ``NeuralNetwork`` (reference
    nn_features.NeuralNetwork): ``nn.Linear`` layers with ReLU between
    them and a linear head. Inference only: no parameter takes a
    gradient."""

    def __init__(self):
        super().__init__()
        self.layers = nn.Sequential()
        self.model_scales = np.zeros((0,))
        self.has_model = False

    # ---- weights ---------------------------------------------------------
    def set_params(self, params):
        """Replace the layers by ``params``, a list of (kernel (in, out),
        bias (out,)) arrays, kept in the arrays' dtype."""
        layers = []
        for i, (k, b) in enumerate(params):
            k = torch.as_tensor(np.array(k))
            lin = nn.Linear(k.shape[0], k.shape[1], dtype=k.dtype)
            lin.weight.data = k.T.contiguous()
            lin.bias.data = torch.as_tensor(np.array(b), dtype=k.dtype)
            layers.append(lin)
            if i < len(params) - 1:
                layers.append(nn.ReLU())
        self.layers = nn.Sequential(*layers).requires_grad_(False)

    @property
    def params(self):
        """The (kernel (in, out), bias (out,)) numpy pairs of the layers."""
        return [(m.weight.detach().T.cpu().numpy(),
                 m.bias.detach().cpu().numpy())
                for m in self.layers if isinstance(m, nn.Linear)]

    def set_scales(self, model_scales):
        """The four scale rows: input offset and width, output offset and
        width (an object array of 1-D rows, as the reference stores), kept
        in the layers' dtype (float64 before any layer is set)."""
        self.model_scales = model_scales
        dtype = (self.layers[0].weight.dtype if len(self.layers)
                 else torch.float64)
        for name, row in zip(("in_shift", "in_width", "out_shift",
                              "out_width"), model_scales):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(row, dtype=float), dtype=dtype))

    def load_model(self, nn_fname, scales_fname):
        if nn_fname.endswith(".npz"):
            data = np.load(nn_fname, allow_pickle=True)
            n_layers = len([k for k in data.files if k.startswith("kernel")])
            params = [(data[f"kernel{i}"], data[f"bias{i}"])
                      for i in range(n_layers)]
        elif nn_fname.endswith((".h5", ".hdf5")):
            params = _load_keras_dense_h5(nn_fname)
        else:
            raise ValueError(f"Unsupported weight format: {nn_fname}")
        self.set_params(params)
        self.set_scales(np.load(scales_fname, allow_pickle=True))
        self.has_model = True

    def save_npz(self, fname):
        arrs = {}
        for i, (k, b) in enumerate(self.params):
            arrs[f"kernel{i}"] = k
            arrs[f"bias{i}"] = b
        np.savez(fname, **arrs)

    # ---- reference-contract pipeline --------------------------------------
    def preprocess(self, inputs):
        """Scale log10 of all input features to (-0.5, 0.5)
        (reference nn_features.py:32-38)."""
        x = torch.log10(inputs)
        return (x - self.in_shift) / self.in_width - 0.5

    def forward(self, x):
        """MLP forward pass: Linear+ReLU hidden layers, linear head."""
        return self.layers(x)

    def postprocess(self, outputs):
        """Undo output scaling; first half are (negative) rates, second half
        coefficients (reference nn_features.py:54-64)."""
        out = (outputs + 0.5) * self.out_width + self.out_shift
        half = out.shape[-1] // 2
        rates = -pow10(out[..., :half])
        coefs = pow10(out[..., half:])
        return torch.cat([rates, coefs], dim=-1)

    def predict(self, t_steps, inputs):
        """TRPL prediction at delay times t_steps for feature rows
        ``inputs`` (reference nn_features.py:40-52)."""
        dev = self.in_shift.device
        x = self.preprocess(torch.as_tensor(np.asarray(inputs), device=dev,
                                            dtype=self.in_shift.dtype))
        coefs = self.postprocess(self(x))[0]
        return multiexp(torch.as_tensor(np.asarray(t_steps), device=dev,
                                        dtype=coefs.dtype), coefs)


def multiexp(x, args):
    """f(x) = sum_i a_i * exp(k_i * x) with args = [k_0..k_z, a_0..a_z]
    (reference nn_features.py:66-91); x (..., n), args (..., 2z)."""
    n = args.shape[-1] // 2
    rates = args[..., :n]
    coefs = args[..., n:]
    return torch.sum(coefs[..., None, :] * torch.exp(
        rates[..., None, :] * x[..., :, None]), dim=-1)


def _load_keras_dense_h5(fname):
    """Extract Dense (kernel, bias) numpy pairs from a keras .h5 weight
    file, in the file's layer order."""
    import h5py

    params = []
    with h5py.File(fname, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        # keras records the true layer order in the 'layer_names' attr;
        # h5py group iteration is alphabetical, which mis-orders
        # dense_10 before dense_2 once there are 11+ layers
        if "layer_names" in root.attrs:
            names = [n.decode() if isinstance(n, bytes) else str(n)
                     for n in root.attrs["layer_names"]]
            names = [n for n in names if n in root]
        else:
            import re

            def natkey(s):  # dense, dense_1, ..., dense_10 in order
                return [int(p) if p.isdigit() else p
                        for p in re.split(r"(\d+)", s)]
            names = sorted(root.keys(), key=natkey)

        def collect(group):
            found = []

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    found.append((name, np.array(obj)))
            group.visititems(visit)
            return found

        for layer in names:
            datasets = dict(collect(root[layer]))
            kernel = next((v for k, v in datasets.items()
                           if k.endswith("kernel:0") or k.endswith("kernel")),
                          None)
            bias = next((v for k, v in datasets.items()
                         if k.endswith("bias:0") or k.endswith("bias")), None)
            if kernel is not None and bias is not None:
                params.append((kernel, bias))
    if not params:
        raise ValueError(f"No Dense layers found in {fname}")
    return params
