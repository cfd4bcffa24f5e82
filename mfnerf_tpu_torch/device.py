"""The device the port's entry points run on."""
import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when it is None. Never falls back to the CPU:
    asking for CUDA where no CUDA device exists raises ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{dev} requested but no CUDA device is available; pass "
            f"device='cpu' to run on the CPU")
    return dev
