"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one. The module
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 outputs differ from the plain version by summation
order only (atol 2e-5); a bf16 output by at most one bf16 rounding of a
value below 4 (atol 2e-2); lse is f32 on both sides (atol 1e-4).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as fa

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel does not run on "
                    "the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,h_kv,d,causal,window", [
    (1, 256, 4, 1, 8, True, None),       # GQA 4, several kv tiles
    (1, 200, 4, 2, 16, False, None),     # ragged, non-causal
    (1, 200, 4, 1, 8, True, 50),         # ragged, window
    (2, 64, 16, 4, 128, True, None),     # the flagship head width
])
def test_flash_fwd_matches_plain_version(card, dtype, b, s, h, h_kv, d,
                                         causal, window):
    rng = np.random.default_rng(s + d)
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(card, td)
               for shape in ((b, s, h, d), (b, s, h_kv, d), (b, s, h_kv, d)))
    before = fa.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal, window)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.cuda
def test_flash_fwd_rejects_a_strided_head_dim(card):
    q = torch.zeros(1, 16, 2, 16, device=card)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)
