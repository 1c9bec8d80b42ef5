"""K3 and K6 at head dim 256 (Gemma-2's) in the port against the JAX
package's golden attention, on the CPU.

The port's ``flash_attention`` (``kernels/flash_attention.py``) takes bf16
q/k/v at head dim 256 and, on CPU tensors, runs K3's plain forward and under
autograd K6's plain backward (the kernels' functions: p rounded to bf16
before P·V, p and ds before the backward's products). They are held to the
JAX ``attention_ref`` (``llm_fp8_tpu/ops/attention.py``, float32 inside,
out in bf16) and to ``jax.vjp`` of it, on the same numpy inputs, with
gemma's softcap 50 and scale ``256**-0.5``, a window that cuts the rows,
GQA, ``q_offset`` and ragged ``kv_lens``, and rows that see no key. q is
drawn at 4x, so the scores (std ~4) are bent by the cap.

Tolerances: the forward within 4 bf16 ulps of the output's largest |value|
(the golden keeps p in float32 where the kernels round it to bf16, 2^-9
relative, and both round the output to bf16). The gradients: the JAX
package's own bf16 gradient tolerance (``tests/test_flash_attention.py``,
rtol = atol = 2e-2), with atol taken relative to each gradient's largest
|value| (dk reaches ~10 here, where 2e-2 absolute would be 2^-9 of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
from llm_fp8_tpu_torch.kernels.flash_attention import BF16_HEAD_DIMS, flash_attention

# One torch thread per test process (see test_torch_zoo_models.py).
torch.set_num_threads(1)

D = 256
CFG = dict(causal=True, softcap=50.0, scale=D ** -0.5)
CASES = {
    # name: (B, Sq, Sk, Hq, Hk, window, q_offset, kv_lens)
    "window_gqa2": (1, 80, 80, 4, 2, 24, [0], [76]),
    "q_offset_ragged": (2, 24, 96, 8, 4, 40, [60, 30], [90, 50]),
    "no_window_gqa4": (1, 70, 70, 8, 2, None, [0], [70]),
    "dead_rows": (2, 16, 48, 4, 2, 6, [0, 30], [48, 20]),
}


def _ulp_tol(ref: np.ndarray, ulps: int = 4) -> float:
    top = np.abs(ref).max()
    return 0.0 if top == 0 else ulps * 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(name):
    B, Sq, Sk, Hq, Hk, window, q_off, kv = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D), (B, Sq, Hq, D)))
    q = q * 4.0
    bf = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in (q, k, v, do)]
    return bf, window, np.asarray(q_off, np.int32), np.asarray(kv, np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_k3_and_k6_at_d256_match_jax_attention_ref(name):
    (q, k, v, do), window, q_off, kv = _inputs(name)
    cfg = dict(CFG, window=window)

    @jax.jit  # eagerly, JAX dispatches the golden op by op (~10x slower here)
    def golden_and_vjp(q, k, v, do, q_off, kv):
        out, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, q_offset=q_off,
                                                             kv_lens=kv, **cfg), q, k, v)
        return out, vjp(do)

    want, want_grads = golden_and_vjp(*(jnp.asarray(a) for a in (q, k, v, do, q_off, kv)))
    want_grads = [np.asarray(g.astype(jnp.float32)) for g in want_grads]
    want = np.asarray(want.astype(jnp.float32))

    qt, kt, vt = (tensor_from_numpy(a).requires_grad_() for a in (q, k, v))
    reset_launch_counts()
    out = flash_attention(qt, kt, vt, q_offset=torch.from_numpy(q_off),
                          kv_lens=torch.from_numpy(kv), **cfg)
    got = torch.autograd.grad(out, (qt, kt, vt), tensor_from_numpy(do))
    assert all(n == 0 for n in launch_counts().values())  # CPU: plain versions only
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=0,
                               atol=_ulp_tol(want))
    for tag, g, w in zip("qkv", got, want_grads):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2,
                                   atol=2e-2 * max(1.0, np.abs(w).max()), err_msg=f"d{tag}")
    if name == "dead_rows":
        # Batch row 1 sees no key (positions 30..45 against kv_len 20 and a
        # window of 6): out and dq are exactly 0 there, on both sides.
        assert (out[1] == 0).all() and (got[0][1] == 0).all()
        assert np.all(want[1] == 0) and np.all(want_grads[0][1] == 0)


def test_d256_is_a_bf16_head_dim_and_others_still_raise():
    assert 256 in BF16_HEAD_DIMS
    # 192 (the MLA family's) runs zero-padded onto the 256 instance since
    # the MLA slice; a dim that no instance takes and none pads to raises.
    q = torch.zeros((1, 4, 2, 192), dtype=torch.bfloat16)
    assert flash_attention(q, q, q).shape == q.shape
    q = torch.zeros((1, 4, 2, 160), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 160"):
        flash_attention(q, q, q)
