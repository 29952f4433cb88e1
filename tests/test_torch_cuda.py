"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and
skips without one.  The file imports no JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: float32 1e-4 (only summation order differs); bf16/fp16 2e-2
on O and 1e-2 on LSE (P is rounded to V's type before the PV product and
the card sums in another order).  Backward: float32 1e-4 on dQ, dK, dV;
bf16 / fp16 2e-2 / 1e-2 of the largest |grad| (dS and P are rounded to
the input type from f32 values that differ in their last bits).
"""

from __future__ import annotations

import numpy as np
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


def _fused_qkv(gen, b, s, h, d, dtype):
    """q, k, v as views of one [B, S, 3 H D] projection (the model's
    layout: row strides of 3 H D elements, read in place)."""
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device="cuda").to(dtype)
    return tuple(t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))


# (dtype, B, Sq, Sk, H, D, causal, window, extra): extra "pad" masks keys
# (batch 0 wholly), "fused" takes q/k/v as views of one projection.
CASES = [
    (torch.bfloat16, 2, 256, 256, 4, 64, True, None, None),
    (torch.bfloat16, 1, 128, 384, 2, 128, True, None, None),
    (torch.bfloat16, 1, 512, 512, 2, 64, True, 100, None),
    (torch.bfloat16, 2, 256, 256, 2, 64, False, None, "pad"),
    (torch.float16, 1, 256, 256, 2, 128, False, -64, None),
    (torch.float32, 2, 256, 256, 2, 64, True, None, "pad"),
    (torch.float32, 1, 128, 256, 2, 128, True, 64, None),
    # The Hopper kernel's edges: one 128-row tile, an odd number of q
    # tiles a head, a negative raw window, fp16 D = 128 with padding, and
    # the training shape in the fused layout.
    (torch.bfloat16, 1, 128, 128, 1, 64, True, None, None),
    (torch.bfloat16, 2, 384, 384, 3, 64, True, None, None),
    (torch.bfloat16, 1, 256, 512, 4, 64, False, -64, None),
    (torch.float16, 2, 256, 256, 4, 128, True, None, "pad"),
    (torch.bfloat16, 8, 1024, 1024, 16, 64, True, None, "fused"),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(case, gen):
    dtype, b, sq, sk, h, d, causal, window, extra = CASES[case]
    if extra == "fused":
        q, k, v = _fused_qkv(gen, b, sq, h, d, dtype)
        assert q.stride(1) == 3 * h * d
    else:
        q, k, v = _qkv(gen, b, sq, sk, h, d, dtype)
    masked = extra == "pad"
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
    q = torch.zeros((1, 128, 1, 64), device="cuda")
    do = torch.zeros((1, 128, 1, 64), device="cuda", dtype=torch.bfloat16)
    o, lse = flash.flash_attention_lse(q, q, q, causal=True)
    with pytest.raises(ValueError, match="dO"):
        flash._flash_backward_kernel(q, q, q, None, o, lse, do, True, 1.0)


# (dtype, B, Sq, Sk, H, D, causal, window, extra): the chip smoke's list
BWD_CASES = [
    (torch.bfloat16, 2, 256, 256, 4, 64, True, None, None),
    (torch.bfloat16, 2, 512, 512, 8, 64, False, None, None),
    (torch.bfloat16, 1, 256, 1024, 8, 64, True, None, None),
    (torch.bfloat16, 1, 2048, 2048, 4, 64, True, 256, None),
    (torch.bfloat16, 2, 256, 256, 4, 64, True, None, "pad"),
    (torch.float32, 2, 256, 256, 4, 64, True, None, None),
    (torch.bfloat16, 2, 512, 512, 8, 128, True, None, None),
    (torch.float32, 1, 256, 512, 4, 128, False, -64, None),
    (torch.float16, 1, 256, 256, 4, 64, True, None, None),
    (torch.bfloat16, 2, 256, 256, 4, 64, True, None, "dlse"),
    # The Hopper kernels' edges: one 128-row tile, an odd number of 128-row
    # tiles, a negative raw window, fp16 D = 128 with padding and fully
    # masked rows, Sk > Sq and Sq > Sk under causality at D = 128 (64-row
    # streamed tiles), and the training shape in the fused layout.
    (torch.bfloat16, 1, 128, 128, 1, 64, True, None, None),
    (torch.bfloat16, 2, 384, 384, 3, 64, True, None, None),
    (torch.bfloat16, 1, 256, 512, 4, 64, False, -64, None),
    (torch.float16, 2, 256, 256, 4, 128, True, None, "pad"),
    (torch.bfloat16, 1, 256, 1024, 8, 128, True, None, None),
    (torch.bfloat16, 1, 512, 256, 4, 128, True, None, None),
    (torch.bfloat16, 8, 1024, 1024, 16, 64, True, None, "fused"),
]
BWD_REL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}


@pytest.mark.parametrize("case", range(len(BWD_CASES)))
def test_backward_kernels_match_plain(case, gen):
    dtype, b, sq, sk, h, d, causal, window, extra = BWD_CASES[case]
    if extra == "fused":
        q, k, v = _fused_qkv(gen, b, sq, h, d, dtype)
    else:
        q, k, v = _qkv(gen, b, sq, sk, h, d, dtype)
    kv_mask = None
    if extra == "pad":
        kv_mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
        kv_mask[0, :128] = False  # causal rows 0..127 of batch 0: empty
    o, lse = flash.flash_attention_lse(q, k, v, causal=causal, scale=0.125,
                                       kv_mask=kv_mask, window=window)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    dlse = None
    if extra == "dlse":
        dlse = torch.randn((b, h, sq), generator=gen, device="cuda")
    before = (flash.dq_launch_count, flash.dkv_launch_count)
    got = flash._flash_backward_kernel(q, k, v, kv_mask, o, lse, do, causal,
                                       0.125, window, dlse)
    assert (flash.dq_launch_count, flash.dkv_launch_count) == \
        (before[0] + 1, before[1] + 1)
    want = flash._flash_backward_reference(q, k, v, kv_mask, o, lse, do,
                                           causal, 0.125, window, dlse)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        tol = 1e-4 if dtype == torch.float32 else \
            BWD_REL[dtype] * w.float().abs().max().item()
        assert g.dtype == dtype and bool(torch.isfinite(g.float()).all())
        assert (g.float() - w.float()).abs().max().item() <= tol
    if extra == "pad":
        gone = ~kv_mask[:, :, None, None]
        assert (got[0][0, :128] == 0).all()
        assert (got[1].masked_select(gone) == 0).all()
        assert (got[2].masked_select(gone) == 0).all()


def test_backward_entries_refuse_unaligned_sequences(gen):
    """The bf16/fp16 kernels walk 128-row tiles: an entry given Sq or Sk
    that is not a multiple of 128 returns an error, and the wrapper
    raises."""
    q = torch.zeros((1, 192, 1, 64), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((1, 256, 1, 64), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 192), device="cuda")
    with pytest.raises(RuntimeError, match="flash_bwd_dq kernel launch"):
        flash._flash_backward_kernel(q, k, k, None, q, lse, q, True, 1.0)
    lse = torch.zeros((1, 1, 256), device="cuda")
    with pytest.raises(RuntimeError, match="flash_bwd_dq kernel launch"):
        flash._flash_backward_kernel(k, q, q, None, k, lse, k, True, 1.0)


def test_autograd_launches_both_backward_kernels(gen):
    q, k, v = (t.requires_grad_() for t in _qkv(gen, 1, 256, 256, 2, 64,
                                                 torch.bfloat16))
    before = (flash.launch_count, flash.dq_launch_count,
              flash.dkv_launch_count)
    flash.flash_attention(q, k, v, causal=True, scale=0.125).sum().backward()
    torch.cuda.synchronize()
    assert (flash.launch_count, flash.dq_launch_count,
            flash.dkv_launch_count) == tuple(n + 1 for n in before)
    assert all(bool(torch.isfinite(t.grad.float()).all())
               for t in (q, k, v))


def test_gpt2_training_step_on_the_card(gen):
    """One AdamW step of a flash-eligible GPT-2 (bf16 compute on float32
    master weights): finite loss and gradients, one forward, dq and dkv
    launch per layer."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    spec = get_model("gpt2-tiny")
    model = spec.init_params(seed=0, device="cuda", train=True,
                             hidden_size=128, num_heads=2)
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", 1e-3))
    state = step_fn.init_state(model)
    tokens = torch.randint(0, 1024, (2, 128), generator=gen, device="cuda")
    before = (flash.launch_count, flash.dq_launch_count,
              flash.dkv_launch_count)
    state, metrics = step_fn(state, {"inputs": tokens})
    torch.cuda.synchronize()
    layers = model.cfg.num_layers
    assert (flash.launch_count, flash.dq_launch_count,
            flash.dkv_launch_count) == tuple(n + layers for n in before)
    assert bool(torch.isfinite(metrics["loss"])) and state["step"] == 1
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def _slot_pool(dtype, n_slots=4):
    """gpt2-tiny on the card with ``n_slots`` prefilled slots (prompt
    lengths 5, 9, 17, ...): (model, pool, prompts)."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.serving.slots import SlotKVManager

    model = get_model("gpt2-tiny").init_params(seed=0, device="cuda",
                                               dtype=dtype)
    pool = SlotKVManager(model, n_slots, max_window=8)
    prompts = [torch.randint(0, 1024, (1, 5 + 4 * s + s * s),
                             generator=torch.Generator().manual_seed(s))
               for s in range(n_slots)]
    for s, p in enumerate(prompts):
        logits, cache = G.prefill(model, p.cuda())
        assert pool.acquire() == s
        pool.insert(s, cache, int(torch.argmax(logits[0])), p.shape[1])
    return model, pool, prompts


def test_slot_step_graph_equals_eager(gen):
    """The W = 8 window as a CUDA-graph replay and eagerly from the same
    state: identical tokens and bitwise-equal caches; a second replay
    captures nothing new."""
    from polyaxon_tpu_torch.analysis.recompile import RecompileSentinel

    for dtype in (torch.bfloat16, torch.float32):
        model, pool, _ = _slot_pool(dtype)
        pool.sentinel = RecompileSentinel()
        state = (pool.tokens.copy(), pool.positions.copy(),
                 pool._k.clone(), pool._v.clone())
        eager = pool.step(8, graph=False)
        k_eager, v_eager = pool._k.clone(), pool._v.clone()
        pool.tokens, pool.positions = state[0].copy(), state[1].copy()
        pool._k.copy_(state[2])
        pool._v.copy_(state[3])
        replay = pool.step(8)
        np.testing.assert_array_equal(replay, eager)
        assert torch.equal(pool._k, k_eager)
        assert torch.equal(pool._v, v_eager)
        pool.step(8)
        snap = pool.sentinel.snapshot()["compile_cache_by_kind"]
        assert snap["slot_step"] == {"misses": 1, "hits": 1,
                                     "evictions": 0}


def test_slot_decode_equals_solo_on_the_card(gen):
    """float32: every slot's window tokens are its solo greedy tokens."""
    from polyaxon_tpu_torch.models import generate as G

    model, pool, prompts = _slot_pool(torch.float32)
    got = np.concatenate([pool.step(4), pool.step(8)])
    for s, p in enumerate(prompts):
        solo = G.generate(model, p.cuda(), max_new_tokens=13)
        assert got[:, s].tolist() == solo[0, -12:].tolist()
