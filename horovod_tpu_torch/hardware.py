"""Accelerator peak-FLOPs lookup for MFU accounting.

Counterpart of horovod_tpu/hardware.py: per-card peak dense bf16 FLOP/s
by ``torch.cuda.get_device_name()``, the benches' MFU denominator.
``HOROVOD_PEAK_FLOPS`` overrides the table. The CPU and unknown cards
resolve to 0.0, which the callers read as "no MFU available".
"""

import shutil
import subprocess

import torch

# Peak dense bf16 FLOP/s per card by device name (NVIDIA H100 data
# sheet: the SXM part at 989.4 TFLOP/s, PCIe at 756 TFLOP/s, without
# sparsity). Both figures assume the card's full power limit.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops_for_kind(device_kind):
    """Peak FLOP/s for a device name, or 0.0 when the name is not in the
    table. A name that starts with a table key matches it (names may
    carry a suffix); an empty name matches nothing."""
    kind = str(device_kind or "")
    if not kind:
        return 0.0
    for k, v in PEAK_BF16_FLOPS.items():
        if kind.startswith(k):
            return float(v)
    return 0.0


def peak_flops_per_chip(config=None, device=None):
    """The MFU denominator: ``config.peak_flops`` (HOROVOD_PEAK_FLOPS)
    when set, else the table entry of ``device``'s card (a CUDA
    ``torch.device``; default: the current card). 0.0 for the CPU and for
    a card the table does not know."""
    if config is not None and getattr(config, "peak_flops", 0.0) > 0.0:
        return float(config.peak_flops)
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return peak_flops_for_kind(torch.cuda.get_device_name(device))


def card_line(index=0):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where there is no ``nvidia-smi`` (the CPU). A card may be set
    below its full power limit, and then runs slower under load, so the
    benches print this beside every rate."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return None
    out = subprocess.run([tool, "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={index}"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]
