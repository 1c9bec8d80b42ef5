"""Attention dropout in the port against the JAX package.

* The keep mask (``kernels/_common.py::dropout_keep_mask``, uint32
  arithmetic emulated on int64) equals JAX ``dropout_keep_mask`` bit for bit
  over a grid of seeds, (batch, head) indices and positions, at rates near
  0, in between and near 1.
* ``attention_ref`` with dropout: output and gradients against JAX's
  (float32, rtol 1e-5 of the largest value; the gradients under jit and
  torch autograd sum in other orders, 1e-4).
* K3's and K6's plain versions: the output is 0 exactly where the plain mask
  drops or masks an entry (V one-hot, the read-back ``chip_smoke.py`` makes
  of the kernels), and the gradients follow the golden's within the flash
  tests' 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels._common import dropout_keep_mask as jax_keep
from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from llm_fp8_tpu_torch.kernels._common import dropout_keep, dropout_keep_mask, dropout_threshold
from llm_fp8_tpu_torch.kernels.flash_attention import flash_attention
from llm_fp8_tpu_torch.ops.attention import attention_ref


@pytest.mark.parametrize("rate", [1e-9, 0.1, 0.5, 0.9, 1 - 1e-9])
def test_keep_mask_equals_jax_bit_for_bit(rate):
    rng = np.random.default_rng(int(rate * 1e6))
    bh = rng.integers(0, 2 ** 15, (6, 1, 1)).astype(np.int32)
    q = rng.integers(0, 2 ** 20, (1, 9, 1)).astype(np.int32)
    k = rng.integers(0, 2 ** 20, (1, 1, 13)).astype(np.int32)
    for seed in (0, 1, 7919, -5, 2 ** 31 - 1, -2 ** 31):
        want = np.asarray(jax_keep(jnp.asarray(seed, jnp.int32), jnp.asarray(bh),
                                   jnp.asarray(q), jnp.asarray(k), rate))
        got = dropout_keep_mask(seed, torch.from_numpy(bh), torch.from_numpy(q),
                                torch.from_numpy(k), rate).numpy()
        np.testing.assert_array_equal(got, want)
    assert dropout_threshold(rate) == min(int(rate * 2 ** 32), 2 ** 32 - 1)


@pytest.mark.parametrize("alibi", [False, True])
def test_attention_ref_dropout_matches_jax(alibi):
    rng = np.random.default_rng(4)
    B, Sq, Sk, Hq, Hk, D = 2, 12, 20, 4, 2, 32
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D), (B, Sq, Hq, D)))
    qo = np.asarray([8, 3], np.int32)
    kw = dict(dropout_p=0.2, dropout_seed=11,
              alibi_slopes=np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32) if alibi else None)

    @jax.jit
    def golden(q_, k_, v_):
        return jax_attention_ref(q_, k_, v_, q_offset=jnp.asarray(qo),
                                 **{**kw, "alibi_slopes": None if kw["alibi_slopes"] is None
                                    else jnp.asarray(kw["alibi_slopes"])})

    want, vjp = jax.vjp(golden, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_g = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tkw = {**kw, "alibi_slopes": None if not alibi else torch.from_numpy(kw["alibi_slopes"])}
    got = attention_ref(tq, tk, tv, q_offset=torch.from_numpy(qo), **tkw)
    top = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5 * top)
    for g, w in zip(torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do)), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(w)).max())


def test_flash_plain_drops_the_plain_mask_and_follows_the_golden():
    rng = np.random.default_rng(6)
    B, S, Hq, Hk, D = 2, 64, 4, 2, 32
    rate, seed = 0.25, 123
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q, k = bf(rng.standard_normal((B, S, Hq, D)) * 0.05), bf(rng.standard_normal((B, S, Hk, D)) * 0.05)
    # V one-hot: output column d of key block j is p_v[..., 32j + d].
    qo = torch.zeros((B,), dtype=torch.int32)
    keep = dropout_keep(seed, rate, qo, B, Hq, S, S) & torch.tril(
        torch.ones((S, S), dtype=torch.bool))
    seen = torch.zeros_like(keep)
    idx = torch.arange(D)
    for j in range(S // D):
        onehot = torch.zeros((B, S, Hk, D), dtype=torch.bfloat16)
        onehot[:, j * D + idx, :, idx] = 1.0
        out = flash_attention(q, k, onehot, dropout_p=rate, dropout_seed=seed)
        seen[..., j * D:(j + 1) * D] = (out != 0).permute(0, 2, 1, 3)
    assert torch.equal(seen, keep)
    assert 0.6 < keep.sum() / torch.tril(torch.ones((S, S))).sum() / B / Hq < 0.9
    # Gradients of K3/K6's plain versions against the golden's.
    v, do = bf(rng.standard_normal((B, S, Hk, D))), bf(rng.standard_normal((B, S, Hq, D)))
    qkv = [t.clone().requires_grad_() for t in (q * 20, k * 20, v)]
    out = flash_attention(*qkv, dropout_p=rate, dropout_seed=seed)
    got = torch.autograd.grad(out, qkv, do)
    f32 = [t.detach().float().requires_grad_() for t in qkv]
    gold = attention_ref(*f32, dropout_p=rate, dropout_seed=seed)
    np.testing.assert_allclose(out.float().detach().numpy(), gold.detach().numpy(), rtol=0,
                               atol=2 * 2.0 ** (np.floor(np.log2(gold.abs().max().item())) - 7))
    for g, w in zip(got, torch.autograd.grad(gold, f32, do.float())):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2, atol=2e-2)
