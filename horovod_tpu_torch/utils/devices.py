"""Where the port runs: ``torch.device`` resolution for every entry
point."""

import torch


def resolve_device(device):
    """``torch.device(device)``, checked: a CUDA device needs a card, and
    on a card f32 matrix products and convolutions stay exact f32 (TF32
    keeps about three decimal digits; the JAX package's f32 products keep
    all of them). cuDNN's convolutions default to TF32, so both switches
    go off."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run the plain versions "
                "of its kernels on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device
