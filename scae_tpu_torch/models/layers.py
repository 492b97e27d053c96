"""Building blocks with torch-default initialisation (counterpart of
scae_tpu/models/layers.py).

Parameter names and layouts are PyTorch's (Linear weight (out, in), Conv2d
weight OIHW); ``utils/from_flax.py`` maps the JAX package's flax trees onto
them. ``StackedMLP`` keeps its flax layout, kernels (O, in, out), and runs
one batched matmul per layer over the O independent capsule MLPs.

Initialisation mirrors the JAX initialisers and draws from an explicit
``torch.Generator``: every module that owns parameters defines
``init_own_parameters(generator)``, and ``init_parameters`` walks a model.
"""

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scae_tpu_torch.ops.math_ops import relu1


def uniform_(tensor: torch.Tensor, bound: float, generator: torch.Generator):
    """U(-bound, bound) in place, from ``generator``."""
    with torch.no_grad():
        tensor.uniform_(-bound, bound, generator=generator)


def torch_default_bound(fan_in: int) -> float:
    """torch's Linear / Conv2d default, kaiming_uniform(a=sqrt(5)), which
    is variance_scaling(1/3, fan_in, uniform): U(+-1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in)


def xavier_bound(fan_in: int, fan_out: int) -> float:
    """torch's xavier_uniform_ with explicitly supplied fans."""
    return math.sqrt(6.0 / (fan_in + fan_out))


def init_parameters(model: nn.Module, generator: torch.Generator):
    """Initialise every parameter of ``model`` from ``generator``, module
    by module in ``model.modules()`` order. LayerNorms keep their ones and
    zeros."""
    for module in model.modules():
        own = getattr(module, "init_own_parameters", None)
        if own is not None:
            own(generator)
        elif isinstance(module, nn.LayerNorm):
            module.reset_parameters()


def choose_activation(name_or_fn) -> Callable:
    """Activation by name."""
    if callable(name_or_fn):
        return name_or_fn
    table = {
        "relu": F.relu,
        "relu1": relu1,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softplus": F.softplus,
        "elu": F.elu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
        "identity": lambda x: x,
    }
    if name_or_fn not in table:
        raise ValueError(f"Unknown activation: {name_or_fn}")
    return table[name_or_fn]


class TorchLinear(nn.Module):
    """Linear layer with torch-default init.

    ``precision="highest"`` computes the product as an exact f32
    multiply-and-sum, never through TF32 whatever the backend flags say;
    the classifier heads use it, as the JAX package runs them at HIGHEST
    precision so that borderline argmaxes do not flip.
    """

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, precision: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.precision = precision
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def init_own_parameters(self, generator):
        bound = torch_default_bound(self.in_features)
        uniform_(self.weight, bound, generator)
        if self.bias is not None:
            uniform_(self.bias, bound, generator)

    def forward(self, x):
        if self.precision == "highest":
            y = torch.sum(x[..., :, None] * self.weight.t(), dim=-2)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight, self.bias)


class TorchConv2d(nn.Module):
    """Valid-padded 2D conv on NCHW inputs with torch-default init.

    ``compute_dtype`` (e.g. "bfloat16") casts activations and weight for
    the convolution; the output returns to f32 before the bias.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, compute_dtype: Optional[str] = None):
        super().__init__()
        self.in_channels = in_channels
        self.stride = stride
        self.compute_dtype = (getattr(torch, compute_dtype)
                              if compute_dtype else None)
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    def init_own_parameters(self, generator):
        k = self.weight.shape[-1]
        bound = torch_default_bound(self.in_channels * k * k)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x):
        w = self.weight
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        y = F.conv2d(x, w, stride=self.stride)
        return y.float() + self.bias[None, :, None, None]


class MLP(nn.Module):
    """Linear + activation stack; like the reference, ``activate_final``
    defaults to True. Layers are ``linear_0``, ``linear_1``, ..."""

    def __init__(self, sizes: Sequence[int], activation=F.relu,
                 activate_final: bool = True, use_bias: bool = True):
        super().__init__()
        if len(sizes) < 2:
            raise ValueError("There must be at least two sizes")
        self.n_layers = len(sizes) - 1
        self.activation = activation
        self.activate_final = activate_final
        for j in range(self.n_layers):
            self.add_module(f"linear_{j}", TorchLinear(
                sizes[j], sizes[j + 1], use_bias=use_bias))

    def forward(self, x):
        for j in range(self.n_layers):
            x = getattr(self, f"linear_{j}")(x)
            if j < self.n_layers - 1 or self.activate_final:
                x = self.activation(x)
        return x


class Conv2dStack(nn.Module):
    """Conv + activation stack. Layers are ``conv_0``, ``conv_1``, ..."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 kernel_sizes: Sequence[int], strides: Sequence[int],
                 activation=F.relu, activate_final: bool = True,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if not len(out_channels) == len(kernel_sizes) == len(strides):
            raise ValueError("out_channels, kernel_sizes and strides differ "
                             "in length")
        self.n_layers = len(out_channels)
        self.activation = activation
        self.activate_final = activate_final
        chans = [in_channels, *out_channels]
        for i in range(self.n_layers):
            self.add_module(f"conv_{i}", TorchConv2d(
                chans[i], chans[i + 1], kernel_sizes[i], strides[i],
                compute_dtype=compute_dtype))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x)
            if i < self.n_layers - 1 or self.activate_final:
                x = self.activation(x)
        return x


class StackedMLP(nn.Module):
    """A bank of ``n_stack`` independent MLPs applied to stacked inputs:
    [..., O, in] -> [..., O, out].

    Kernels are stored (O, in, out) and biases (O, out), as in the JAX
    package; each layer is one batched matmul over the O capsules, each
    capsule keeping its own weights.
    """

    def __init__(self, n_stack: int, sizes: Sequence[int], activation=F.relu,
                 activate_final: bool = True, use_bias: bool = True):
        super().__init__()
        if len(sizes) < 2:
            raise ValueError("There must be at least two sizes")
        self.n_stack = n_stack
        self.sizes = tuple(sizes)
        self.n_layers = len(sizes) - 1
        self.activation = activation
        self.activate_final = activate_final
        self.use_bias = use_bias
        for j in range(self.n_layers):
            self.register_parameter(f"kernel_{j}", nn.Parameter(
                torch.empty(n_stack, sizes[j], sizes[j + 1])))
            if use_bias:
                self.register_parameter(f"bias_{j}", nn.Parameter(
                    torch.empty(n_stack, sizes[j + 1])))

    def init_own_parameters(self, generator):
        for j in range(self.n_layers):
            bound = torch_default_bound(self.sizes[j])
            uniform_(getattr(self, f"kernel_{j}"), bound, generator)
            if self.use_bias:
                uniform_(getattr(self, f"bias_{j}"), bound, generator)

    def forward(self, x):
        lead = x.shape[:-2]
        O = x.shape[-2]      # n_stack, or the share of a split bank
        h = x.reshape(-1, O, x.shape[-1]).transpose(0, 1)     # (O, N, in)
        for j in range(self.n_layers):
            kernel = getattr(self, f"kernel_{j}")
            if self.use_bias:
                bias = getattr(self, f"bias_{j}")
                h = torch.baddbmm(bias[:, None, :], h, kernel)
            else:
                h = torch.bmm(h, kernel)
            if j < self.n_layers - 1 or self.activate_final:
                h = self.activation(h)
        return h.transpose(0, 1).reshape(*lead, O, h.shape[-1])
