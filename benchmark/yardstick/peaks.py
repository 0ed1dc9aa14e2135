"""Published peaks of the cards the benchmark runs on (NVIDIA's H100
data sheet, the SXM part, dense rates without sparsity, at the full
700 W power limit). Every roofline and MFU is stated against them; the
card's power limit is printed beside each run."""

# torch.cuda.get_device_name() -> peaks
CARDS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

#: The card every rate is held to where the device name is unknown (the
#: CPU tests): the H100 SXM, the card the benchmark is written for.
DEFAULT = "NVIDIA H100 80GB HBM3"


def of(kind):
    """The peaks of the card named ``kind``; a name that starts with a
    table key matches it, anything else gets the H100 SXM's."""
    for name, peaks in CARDS.items():
        if str(kind or "").startswith(name):
            return peaks
    return CARDS[DEFAULT]
