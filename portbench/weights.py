"""Every parameter of a model drawn from the run's seed, on the device, in
one call of a seeded ``torch.Generator``.

The draw is a function of the parameters' names and shapes alone (the
reference model's, which match the port's), so the program and the
reference load the same state dict. The ranges follow the usual
initialisation of each kind of leaf: U(+-1/sqrt(fan_in)) for the weights
and biases of linear, convolutional and stacked layers, Xavier's range for
the set transformer's learned queries, U(0, 1) for the template logits and
the output scale, ones and zeros for layer norms, and zeros for the leaves
that start at zero (embedding bias, alpha templates, background values,
the static capsule parts and biases, the dummy vote).
"""

import math
import re

import torch

ZERO = re.compile(r"(img_embedding_bias|templates_alpha|bg_mixing_logit|"
                  r"bg_value|cpr_static|caps_bias_\d+|dummy_vote)$")
UNIT = re.compile(r"(template_logits|part_decoder\.scale)$")
XAVIER = re.compile(r"(\.seeds|\.S|\.I)$")
NORM = re.compile(r"\.ln\d\.(weight|bias)$")


def fan_in(name, shapes):
    """The fan-in of the layer that a weight or bias belongs to."""
    if name.endswith(".bias"):
        return fan_in(name[:-len("bias")] + "weight", shapes)
    stacked = re.search(r"\.bias_(\d+)$", name)
    if stacked:
        return fan_in(name[:stacked.start()] + f".kernel_{stacked[1]}",
                      shapes)
    shape = shapes[name]
    if re.search(r"\.kernel_\d+$", name):
        return shape[1]
    return math.prod(shape[1:])


def ranges(shapes):
    """{name: (low, high)} of every leaf."""
    out = {}
    for name, shape in shapes.items():
        if ZERO.search(name):
            out[name] = (0.0, 0.0)
        elif UNIT.search(name):
            out[name] = (0.0, 1.0)
        elif NORM.search(name):
            v = 1.0 if name.endswith("weight") else 0.0
            out[name] = (v, v)
        elif XAVIER.search(name):
            _, n, d = shape
            b = math.sqrt(6.0 / (n * d + d))
            out[name] = (-b, b)
        else:
            b = 1.0 / math.sqrt(fan_in(name, shapes))
            out[name] = (-b, b)
    return out


def draw(shapes, seed, device):
    """{name: float32 tensor on ``device``}: one uniform draw of every
    leaf's entries from ``torch.Generator(device).manual_seed(seed)``,
    scaled to each leaf's range."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (lo, hi) in ranges(shapes).items():
        n = math.prod(shapes[name])
        out[name] = (flat[at:at + n] * (hi - lo) + lo).reshape(shapes[name])
        at += n
    return out


def shapes_of(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def model_shapes(model_cfg):
    """The leaves' shapes of a configuration's model, from the reference
    model built on the meta device."""
    from portbench.reference.model import Model

    with torch.device("meta"):
        return shapes_of(Model(model_cfg))


def draw_for(model_cfg, seed, device):
    """Every leaf of a configuration's model, drawn from ``seed``."""
    return draw(model_shapes(model_cfg), seed, device)
