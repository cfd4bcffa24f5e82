"""The device the port's entry points run on, and its float32 precision."""
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


def no_tf32():
    """Keep float32 matmuls and convolutions in IEEE float32 on the card, as
    the JAX package computes them on the CPU: TF32 off for cuBLAS and
    cuDNN. PyTorch leaves cuDNN's convolutions in TF32 by default. The
    legacy flags are the ones set: where this torch also has the
    ``fp32_precision`` settings, setting the flags sets those (matmul
    "ieee", cuDNN's inherited), and setting both kinds would mix the two
    APIs, which PyTorch refuses to read back. Every entry point calls it
    (``train.main``, ``eval.main``, ``show_gui.main``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_off() -> bool:
    """True when neither cuBLAS nor cuDNN may compute float32 in TF32: the
    legacy flags, and the ``fp32_precision`` settings where this torch has
    them."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        return False
    for backend in (torch.backends.cuda.matmul,
                    getattr(torch.backends.cudnn, "conv", None)):
        if getattr(backend, "fp32_precision", "ieee") == "tf32":
            return False
    return True
