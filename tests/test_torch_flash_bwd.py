"""K6 in the port (``kernels/flash_attention_bwd.py``) against the JAX
flash-attention backward.

The port's ``flash_attention`` on CPU tensors runs K3's plain forward and,
under autograd, K6's plain backward (``flash_attention_bwd_plain``). Its
gradients are held to ``jax.grad`` of the JAX ``flash_attention`` (forward
and backward Pallas kernels in interpret mode) for causal attention with GQA
1:1, 4:1 and 8:1, ragged ``kv_lens``, ``q_offset``, a sliding window,
softcap, head_dim 32 and 64, query lengths that are no multiple of a tile,
and fully masked rows (gradients exactly 0, no NaN).

Tolerance against JAX: each gradient within 4 bf16 ulps of its largest
|value| (both sides recompute p from their own LSE, round p and ds to bf16 at
the same places and sum in float32 in other orders). Against torch autograd of
the port's float32 ``attention_ref``: the JAX package's own bf16 gradient
tolerance (``tests/test_flash_attention.py:29-35``, rtol = atol = 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.flash_attention import flash_attention as jax_flash
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
from llm_fp8_tpu_torch.kernels.flash_attention import f32_card_refuses, flash_attention
from llm_fp8_tpu_torch.kernels.flash_attention_bwd import flash_attention_bwd
from llm_fp8_tpu_torch.ops.attention import attention_ref

CASES = {
    # name: (B, Sq, Sk, Hq, Hk, D, kwargs, q_offset, kv_lens)
    "gqa1": (2, 64, 64, 4, 4, 64, {}, [0, 0], [64, 64]),
    "gqa4_ragged": (2, 64, 64, 8, 2, 32, {}, [0, 0], [64, 37]),
    "gqa8": (1, 40, 40, 8, 1, 32, {}, [0], [40]),
    "q_offset": (2, 16, 80, 4, 2, 32, {}, [64, 30], [80, 46]),
    "window": (2, 48, 48, 4, 2, 32, {"window": 9}, [0, 0], [48, 41]),
    "softcap": (2, 32, 32, 4, 2, 32, {"softcap": 5.0, "scale": 0.6}, [0, 0], [32, 32]),
    "d64_unaligned": (1, 100, 100, 4, 2, 64, {}, [0], [100]),
    "dead_rows": (2, 8, 40, 4, 2, 32, {"window": 4}, [0, 30], [40, 20]),
}


def _jax_grads(q, k, v, do, q_off, kv, cfg):
    def loss(q, k, v):
        out = jax_flash(q, k, v, q_offset=q_off, kv_lens=kv, interpret=True, **cfg)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)


def _ulp_tol(ref: np.ndarray, ulps: int = 4) -> float:
    top = np.abs(ref).max()
    return 0.0 if top == 0 else ulps * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_k6_matches_jax_backward(name):
    B, Sq, Sk, Hq, Hk, D, kw, q_off, kv = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, do = (jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jnp.bfloat16)
                   for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D), (B, Sq, Hq, D)))
    cfg = dict(causal=True, window=kw.get("window"), softcap=kw.get("softcap"),
               scale=kw.get("scale", D ** -0.5))
    q_off_np, kv_np = np.asarray(q_off, np.int32), np.asarray(kv, np.int32)
    ref = [np.asarray(g.astype(jnp.float32))
           for g in _jax_grads(q, k, v, do, jnp.asarray(q_off_np), jnp.asarray(kv_np), cfg)]

    qt, kt, vt = (tensor_from_numpy(np.asarray(a)).requires_grad_() for a in (q, k, v))
    dot = tensor_from_numpy(np.asarray(do))
    reset_launch_counts()
    out = flash_attention(qt, kt, vt, q_offset=torch.from_numpy(q_off_np),
                          kv_lens=torch.from_numpy(kv_np), **cfg)
    got = torch.autograd.grad(out, (qt, kt, vt), dot)
    assert all(n == 0 for n in launch_counts().values())  # CPU: plain versions only
    for name_g, g, r in zip("qkv", got, ref):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=_ulp_tol(r),
                                   err_msg=f"d{name_g}")

    # The port's float32 golden attention under torch autograd.
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (qt, kt, vt))
    gold = attention_ref(q32, k32, v32, q_offset=torch.from_numpy(q_off_np),
                         kv_lens=torch.from_numpy(kv_np), **cfg)
    want = torch.autograd.grad(gold, (q32, k32, v32), dot.float())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2, atol=2e-2)

    if name == "dead_rows":
        # Batch row 1 sees no key (q_pos 30..37 > kv_len 20 + window): its
        # LSE is -inf, p is 0 and dq is exactly 0.
        assert (got[0][1] == 0).all()
        assert np.all(ref[0][1] == 0)


def test_backward_raises_on_what_the_forward_refuses():
    # ALiBi, dropout, the chunk and segment ids are ported: their backward
    # matches the gradient of attention_ref under torch autograd (tolerances
    # of the cases above). Only K6's float32 instance still refuses the
    # chunk and segment ids, on the card's path.
    rng = np.random.default_rng(5)
    qkv = [torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
           .to(torch.bfloat16).requires_grad_() for _ in range(3)]
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 0]], dtype=torch.int32)
    for kw in ({"alibi_slopes": torch.tensor([0.5, 0.25])},
               {"dropout_p": 0.25, "dropout_seed": 3}, {"attention_chunk": 3},
               {"q_segment_ids": seg, "kv_segment_ids": seg}):
        out = flash_attention(*qkv, **kw)
        got = torch.autograd.grad(out, qkv, torch.ones_like(out))
        f32 = [t.detach().float().requires_grad_() for t in qkv]
        want = torch.autograd.grad(attention_ref(*f32, **kw), f32, torch.ones_like(out).float())
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2, atol=2e-2)
    for kw in ({"attention_chunk": 4}, {"segment_ids": seg}):
        with pytest.raises(NotImplementedError, match="float32 instances"):
            f32_card_refuses(**kw)


def test_plain_k6_gradients_are_deterministic():
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                   for s in ((1, 40, 8, 32), (1, 40, 2, 32), (1, 40, 2, 32), (1, 40, 8, 32)))
    out, lse = flash_attention(q, k, v, return_lse=True)
    zero, lens = torch.zeros(1, dtype=torch.int32), torch.full((1,), 40, dtype=torch.int32)
    kw = dict(causal=True, window=None, softcap=None, scale=32 ** -0.5, q_offset=zero,
              kv_lens=lens)
    a = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    b = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
