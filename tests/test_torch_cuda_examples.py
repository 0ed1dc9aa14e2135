"""The port's examples on the card (marker ``cuda``; skipped without one).

Run there without JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_examples.py``. chip_smoke.py's examples phase, as
it runs in the smoke run: the six kernels against their plain versions
at the long-context example's D 64 shapes, then
``transformer_long_context.py --attention ring-flash --sp 4 --window
1024`` at its default width, every attention launch on the tensor-core
route, and the ResNet-50 recipe trained, checkpointed and resumed.
"""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_examples_phase_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke
    from horovod_tpu_torch.ops import flash_attention as fa

    card = torch.device("cuda")
    gen = torch.Generator(device=card).manual_seed(0)
    launches, row = chip_smoke.phase_examples(fa, card, gen, "card test")
    for name in chip_smoke.PREFIXES:
        assert launches[name] == 0, name
        assert launches[chip_smoke.WGMMA[name]] > 0, name
    assert row["lc_losses"][-1] < row["lc_losses"][0]
    assert row["resnet_resumed_losses"]
