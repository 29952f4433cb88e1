"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 1e-4 (only summation order differs); bf16/fp16 2e-2
on O and 1e-2 on LSE (P is rounded to V's type before the PV product and
the card sums in another order).
"""

from __future__ import annotations

import pytest
import torch

from polyaxon_tpu_torch.ops import flash

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2),
       torch.float16: (2e-2, 1e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, sq, sk, h, d, dtype):
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda")
                 .to(dtype) for s in (sq, sk, sk))


# (dtype, B, Sq, Sk, H, D, causal, window, masked)
CASES = [
    (torch.bfloat16, 2, 256, 256, 4, 64, True, None, False),
    (torch.bfloat16, 1, 128, 384, 2, 128, True, None, False),
    (torch.bfloat16, 1, 512, 512, 2, 64, True, 100, False),
    (torch.bfloat16, 2, 256, 256, 2, 64, False, None, True),
    (torch.float16, 1, 256, 256, 2, 128, False, -64, False),
    (torch.float32, 2, 256, 256, 2, 64, True, None, True),
    (torch.float32, 1, 128, 256, 2, 128, True, 64, False),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(case, gen):
    dtype, b, sq, sk, h, d, causal, window, masked = CASES[case]
    q, k, v = _qkv(gen, b, sq, sk, h, d, dtype)
    kv_mask = None
    if masked:
        kv_mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
        kv_mask[0] = False  # batch 0: every row fully masked
    before = flash.launch_count
    o, lse = flash.flash_attention_lse(q, k, v, causal=causal, scale=0.125,
                                       kv_mask=kv_mask, window=window)
    assert flash.launch_count == before + 1
    o_ref, lse_ref = flash._flash_forward_reference(q, k, v, kv_mask, causal,
                                                    0.125, window)
    torch.cuda.synchronize()
    tol_o, tol_l = TOL[dtype]
    assert o.dtype == dtype and lse.shape == (b, h, sq)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol_o
    assert (lse - lse_ref).abs().max().item() <= tol_l
    if masked:
        assert (o[0] == 0).all() and (lse[0] == flash.NEG_INF).all()


def test_kernel_refuses_what_it_does_not_take(gen):
    q = torch.zeros((1, 128, 1, 192), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention(q, q, q, causal=True)
    q = torch.zeros((1, 128, 1, 64), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash.flash_attention(q, q, q, causal=True)
