"""Bridge from the JAX package's flax parameter trees to the port's
``state_dict``s.

Input: a flax parameter tree as nested dicts of array-likes (numpy arrays;
anything ``numpy.asarray`` takes). Module paths are identical in the two
packages; only the leaves differ, as set out in
scae_tpu/models/layers.py:

  * Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
  * Conv ``kernel`` HWIO                  -> ``weight`` OIHW
  * StackedMLP ``kernel_j`` (O, in, out) and ``bias_j`` (O, out) stay
  * LayerNorm (``ln0``, ``ln1``) ``scale`` -> ``weight``
  * every other leaf keeps its name and layout.

``load_flax_params`` loads strictly: a missing or unexpected key raises.
"""

from typing import Dict, Mapping

import numpy as np
import torch

_LAYER_NORMS = ("ln0", "ln1")


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert a flax parameter (sub)tree to the matching port module's
    ``state_dict`` (f32 tensors on the CPU)."""
    out = {}
    for path, value in _flatten(params):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        *parents, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at "
                                 f"{'/'.join(path)}")
            leaf = "weight"
        elif leaf == "scale" and parents and parents[-1] in _LAYER_NORMS:
            leaf = "weight"
        out[".".join([*parents, leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping):
    """Load a flax parameter tree into ``module`` strictly, onto the
    module's own device."""
    state = flax_to_state_dict(params)
    module.load_state_dict(state, strict=True)
    return module
