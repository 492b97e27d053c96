"""Load trained torch-scae weights into the port (counterpart of
scae_tpu/utils/torch_port.py).

A user of the PyTorch reference (bdsaglam/torch-scae) brings a trained
``state_dict`` along: ``port_scae`` maps it to the port's ``state_dict``,
which ``load_state_dict(strict=True)`` takes. It is the JAX package's
``port_scae`` composed with ``utils/from_flax.py``, done in one step:

  * Linear and Conv2d weights keep torch's layout, (out, in) and OIHW,
    which the port's layers share (the JAX package transposes them to
    flax kernels and ``from_flax`` transposes them back);
  * nn.Sequential MLP indices (0, 2, ...) -> ``linear_{j}``, Conv2dStack
    indices -> ``conv_{j}``;
  * the reference's per-capsule nn.ModuleList MLP banks
    (object_decoder.py:86-107) -> the stacked (O, in, out) ``kernel_{j}``
    and (O, out) ``bias_{j}`` of ``models.layers.StackedMLP``;
  * the four separate q/k/v/o projections of an attention block -> the
    fused ``qkv_projector`` of self-attention, or ``q_projector`` and
    ``kv_projector`` of cross-attention (their rows concatenated);
  * the classifiers' Sequential(Linear, Softmax) -> the Linear alone.

The reference's module naming mirrors torch_scae/factory.py:152-178.
"""

import re
from typing import Dict, Mapping

import torch


def _t(x) -> torch.Tensor:
    """An f32, contiguous CPU copy."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous()


def _join(prefix: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def _lin(sd, prefix):
    return {"weight": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _mlp(sd, prefix):
    """Sequential MLP '{prefix}.{2j}.weight/bias' -> linear_{j}."""
    out, j = {}, 0
    while f"{prefix}.{2 * j}.weight" in sd:
        out[f"linear_{j}.weight"] = _t(sd[f"{prefix}.{2 * j}.weight"])
        if f"{prefix}.{2 * j}.bias" in sd:
            out[f"linear_{j}.bias"] = _t(sd[f"{prefix}.{2 * j}.bias"])
        j += 1
    assert j > 0, f"no MLP layers under {prefix}"
    return out


def _conv_stack(sd, prefix):
    out, j = {}, 0
    while f"{prefix}.{2 * j}.weight" in sd:
        out.update(_join(f"conv_{j}", _lin(sd, f"{prefix}.{2 * j}")))
        j += 1
    assert j > 0, f"no conv layers under {prefix}"
    return out


def _stacked_mlp(sd, prefix, n_stack, use_bias=True):
    """nn.ModuleList of per-capsule MLPs -> StackedMLP (O, in, out)
    kernels and (O, out) biases."""
    out, j = {}, 0
    while f"{prefix}.0.{2 * j}.weight" in sd:
        out[f"kernel_{j}"] = torch.stack(
            [_t(sd[f"{prefix}.{i}.{2 * j}.weight"]).T
             for i in range(n_stack)]).contiguous()
        if use_bias:
            out[f"bias_{j}"] = torch.stack(
                [_t(sd[f"{prefix}.{i}.{2 * j}.bias"])
                 for i in range(n_stack)])
        j += 1
    assert j > 0, f"no stacked MLP layers under {prefix}"
    return out


def _cat_lins(*lins):
    """Separate projections as one fused one: their output rows
    concatenated (the layout MultiHeadQKVAttention splits)."""
    return {k: torch.cat([lin[k] for lin in lins]) for k in lins[0]}


def _mqkv(sd, prefix, mode="kv"):
    """The reference's 4 projections in the fused layout: mode 'qkv'
    (self-attention, one projector) or 'kv' (separate q, fused k/v)."""
    q, k, v = (_lin(sd, f"{prefix}.{n}_projector") for n in "qkv")
    out = _join("o_projector", _lin(sd, f"{prefix}.o_projector"))
    if mode == "qkv":
        out.update(_join("qkv_projector", _cat_lins(q, k, v)))
    else:
        out.update(_join("q_projector", q))
        out.update(_join("kv_projector", _cat_lins(k, v)))
    return out


def _mab(sd, prefix, mode="kv"):
    out = _join("mqkv", _mqkv(sd, f"{prefix}.mqkv", mode))
    out.update(_join("fc", _lin(sd, f"{prefix}.fc")))
    for ln in ("ln0", "ln1"):
        if f"{prefix}.{ln}.weight" in sd:
            out.update(_join(ln, _lin(sd, f"{prefix}.{ln}")))
    return out


def port_capsule_image_encoder(sd, prefix):
    out = _join("encoder.network", _conv_stack(
        sd, f"{prefix}.encoder.network"))
    out.update(_join("att_conv", _lin(sd, f"{prefix}.att_conv")))
    out["img_embedding_bias"] = _t(sd[f"{prefix}.img_embedding_bias"])
    return out


def port_template_generator(sd, prefix):
    out = {"template_logits": _t(sd[f"{prefix}.template_logits"])}
    if any(k.startswith(f"{prefix}.templates_color_mlp") for k in sd):
        out.update(_join("templates_color_mlp", _mlp(
            sd, f"{prefix}.templates_color_mlp")))
    return out


def port_template_decoder(sd, prefix):
    out = {"bg_mixing_logit": _t(sd[f"{prefix}.bg_mixing_logit"])}
    for name in ("templates_alpha", "temperature_logit", "scale",
                 "bg_value"):
        if f"{prefix}.{name}" in sd:
            out[name] = _t(sd[f"{prefix}.{name}"])
    return out


def port_set_transformer(sd, prefix):
    out = {**_join("fc1", _lin(sd, f"{prefix}.fc1")),
           **_join("fc2", _lin(sd, f"{prefix}.fc2")),
           "seeds": _t(sd[f"{prefix}.seeds"]),
           **_join("multi_head_attention", _mqkv(
               sd, f"{prefix}.multi_head_attention"))}
    n_layers = len({m.group(1) for k in sd if (m := re.match(
        rf"{re.escape(prefix)}\.sabs\.(\d+)\.", k))})
    for i in range(n_layers):
        p = f"{prefix}.sabs.{i}"
        if f"{p}.mab.fc.weight" in sd:
            layer = _join("mab", _mab(sd, f"{p}.mab", mode="qkv"))
        else:   # ISAB (inducing-point queries: cross-attention)
            layer = {**_join("mab0", _mab(sd, f"{p}.mab0")),
                     **_join("mab1", _mab(sd, f"{p}.mab1")),
                     "I": _t(sd[f"{p}.I"])}
        out.update(_join(f"sab_{i}", layer))
    return out


def port_capsule_object_decoder(sd, n_caps, prefix):
    p = f"{prefix}.capsule_layer"
    layer = {**_join("mlps", _stacked_mlp(sd, f"{p}.mlps", n_caps)),
             **_join("caps_mlps", _stacked_mlp(sd, f"{p}.caps_mlps", n_caps,
                                               use_bias=False)),
             "cpr_static": _t(sd[f"{p}.cpr_static"])}
    for i in range(4):
        layer[f"caps_bias_{i}"] = _t(sd[f"{p}.caps_bias_list.{i}"])
    return {**_join("capsule_layer", layer),
            "dummy_vote": _t(sd[f"{prefix}.dummy_vote"])}


def port_scae(sd: Mapping, n_obj_caps: int) -> Dict[str, torch.Tensor]:
    """A full reference SCAE ``state_dict`` (tensors or numpy arrays) ->
    the port SCAE's ``state_dict`` (f32 CPU tensors)."""
    out = {
        **_join("part_encoder", port_capsule_image_encoder(
            sd, "part_encoder")),
        **_join("template_generator", port_template_generator(
            sd, "template_generator")),
        **_join("part_decoder", port_template_decoder(sd, "part_decoder")),
        **_join("obj_encoder", port_set_transformer(sd, "obj_encoder")),
        **_join("obj_decoder", port_capsule_object_decoder(
            sd, n_obj_caps, "obj_decoder")),
    }
    for name in ("prior_classifier", "posterior_classifier"):
        if f"{name}.0.weight" in sd:
            out.update(_join(name, _lin(sd, f"{name}.0")))
    return out
