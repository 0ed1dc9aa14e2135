"""Small MLP for MNIST-scale examples and tests.

Counterpart of horovod_tpu/models/mlp.py: the input flattened per
example and cast to f32, ``Dense`` + ReLU per hidden width, a ``Dense``
head; parameters ``Dense_0``, ``Dense_1``, ... as Flax names them, so
``params_from_jax`` converts a Flax tree (dense kernels (in, out) ->
(out, in)).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.devices import resolve_device
from ._flax_ops import Dense
from ._flax_ops import params_from_jax, params_to_numpy  # noqa: F401


class MnistMLP(nn.Module):
    def __init__(self, in_features=784, features=(128, 64), num_classes=10,
                 generator=None, device="cuda"):
        super().__init__()
        widths = [in_features, *features, num_classes]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                                torch.float32, generator))
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).float()
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x
