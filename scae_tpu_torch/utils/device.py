"""The device an entry point runs on."""

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Raises where CUDA is
    asked for (explicitly or by default) and absent: the port never drops
    to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_model_device(model: torch.nn.Module, device: torch.device):
    """Raise unless every parameter of ``model`` lies on ``device``."""
    for name, p in model.named_parameters():
        if p.device != device:
            raise ValueError(f"parameter {name} is on {p.device}, the entry "
                             f"point runs on {device}")
