"""Attention in the port against the JAX package.

* K3's plain version (``flash_fwd_plain`` behind ``flash_attention`` on CPU
  tensors) against the JAX flash forward (``_flash_fwd_call`` in Pallas
  interpret mode), out and LSE, dead rows included.
* K2's plain version against the JAX ``decode_attention_arena`` kernel
  (interpret mode) with append and rotary over e4m3, int8 and bf16 arenas:
  output within tolerance and the appended arena codes bit for bit, after
  transposing the JAX arena ``[L, B, Hk, D, S]`` to the port's
  ``[L, B, Hk, S, D]``.
* ``attention_ref`` and ``decode_attention`` (plain XLA in JAX, plain torch
  here) in float32.

Tolerances: the kernels' float32 scores and PV sums agree up to summation
order, and both round P and the output to bf16, so bf16 outputs agree within
one bf16 ulp of the largest output; the LSE to rtol 1e-5. The float32
references agree to rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.decode_attention import decode_attention_arena as jax_arena
from llm_fp8_tpu.kernels.flash_attention import _flash_fwd_call
from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from llm_fp8_tpu.ops.attention import decode_attention as jax_decode_attention
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import KERNEL_WRAPPERS
from llm_fp8_tpu_torch.kernels.decode_attention import decode_attention_arena
from llm_fp8_tpu_torch.kernels.flash_attention import f32_card_refuses, flash_attention
from llm_fp8_tpu_torch.ops.attention import attention, attention_ref, decode_attention


# Jitted: the Pallas interpreter dispatched eagerly is several times slower.
jax_flash_fwd = jax.jit(_flash_fwd_call, static_argnames=(
    "causal", "window", "softcap", "scale", "block_q", "block_k", "interpret"))


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


FLASH_CASES = {
    # name: (B, Sq, Sk, Hq, Hk, D, kwargs, q_offset, kv_lens)
    "causal": (2, 40, 40, 4, 2, 32, {}, [0, 0], [40, 40]),
    "q_offset": (2, 8, 48, 4, 2, 32, {}, [40, 20], [48, 28]),
    "ragged": (2, 40, 40, 4, 4, 64, {}, [0, 0], [40, 17]),
    "gqa4": (1, 24, 24, 8, 2, 32, {}, [0], [24]),
    "window": (2, 40, 40, 4, 2, 32, {"window": 7}, [0, 0], [40, 33]),
    "softcap": (2, 32, 32, 4, 2, 32, {"softcap": 5.0, "scale": 0.6}, [0, 0], [32, 32]),
    "dead_rows": (2, 8, 40, 4, 2, 32, {"window": 4}, [0, 30], [40, 20]),
    "noncausal": (2, 16, 24, 4, 2, 32, {"causal": False}, [0, 0], [24, 9]),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_plain_matches_jax_flash_forward(name):
    B, Sq, Sk, Hq, Hk, D, kw, q_off, kv = FLASH_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jnp.bfloat16)
               for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))
    cfg = dict(causal=kw.get("causal", True), window=kw.get("window"),
               softcap=kw.get("softcap"), scale=kw.get("scale", D ** -0.5))
    q_off, kv = np.asarray(q_off, np.int32), np.asarray(kv, np.int32)
    ref, ref_lse = jax_flash_fwd(q, k, v, jnp.asarray(q_off), jnp.asarray(kv), block_q=128,
                                 block_k=128, interpret=True, **cfg)
    ref = np.asarray(ref.astype(jnp.float32))
    ref_lse = np.asarray(ref_lse)[:, :, 0, :Sq]
    out, lse = flash_attention(_t(q), _t(k), _t(v), q_offset=torch.from_numpy(q_off),
                               kv_lens=torch.from_numpy(kv), return_lse=True, **cfg)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5)
    if name == "dead_rows":
        assert np.isneginf(ref_lse[1]).all() and (out[1] == 0).all()


@pytest.mark.parametrize("feature", ["alibi_slopes", "attention_chunk", "q_segment_ids",
                                     "dropout_p"])
def test_flash_unported_features_raise(feature):
    # Every feature is ported: each case checks that K3 (its plain version)
    # follows attention_ref with it, within two bf16 ulps (P is rounded to
    # bf16 in K3 only). The chunk and segment ids (packed: two sequences and
    # a padding tail of id 0) still raise on the card's path of K3's float32
    # instance, which is all that raises now.
    seg = torch.tensor([[1] * 5 + [2] * 7 + [0] * 4], dtype=torch.int32)
    kw = {"alibi_slopes": {"alibi_slopes": torch.tensor([0.5, 0.125])},
          "attention_chunk": {"attention_chunk": 5},
          "q_segment_ids": {"q_segment_ids": seg, "kv_segment_ids": seg},
          "dropout_p": {"dropout_p": 0.3}}[feature]
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 32)).astype(np.float32)).to(
        torch.bfloat16)
    out = flash_attention(q, q, q, **kw).float().numpy()
    ref = attention_ref(q.float(), q.float(), q.float(), **kw).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 * _ulp(ref))
    if feature in ("attention_chunk", "q_segment_ids"):
        with pytest.raises(NotImplementedError, match="float32 instances"):
            f32_card_refuses(attention_chunk=kw.get("attention_chunk"),
                             segment_ids=kw.get("q_segment_ids"))


def test_flash_kv_lens_needs_one_length_per_row():
    # The kernel reads kv_lens[b] for every batch row b.
    q = torch.zeros((2, 4, 4, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, q, q, kv_lens=torch.full((1,), 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, q, q, kv_lens=torch.full((2, 1), 4, dtype=torch.int32))
    assert flash_attention(q, q, q, kv_lens=torch.full((2,), 4, dtype=torch.int32)).shape == q.shape


def test_flash_backward_is_not_faked():
    # The backward is K6 from the saved out and LSE: on CPU tensors exactly
    # its plain version (held to JAX in tests/test_torch_flash_bwd.py).
    from llm_fp8_tpu_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain

    q, k, v = (torch.randn(s).to(torch.bfloat16).requires_grad_()
               for s in ((1, 4, 4, 32), (1, 4, 2, 32), (1, 4, 2, 32)))
    out, lse = flash_attention(q, k, v, return_lse=True)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse, do, causal=True, window=None,
        softcap=None, scale=32 ** -0.5, q_offset=torch.zeros(1, dtype=torch.int32),
        kv_lens=torch.full((1,), 4, dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(bool(g.float().abs().sum() > 0) for g in got)


def _arena_case(dtype_name, seed, L=2, B=3, Hq=8, Hk=2, D=32, S=128):
    """A quantized arena in the JAX layout, inputs and per-head scales."""
    rng = np.random.default_rng(seed)
    jdt = {"e4m3": jnp.float8_e4m3fn, "int8": jnp.int8, "bf16": jnp.bfloat16}[dtype_name]
    scales = {"e4m3": (0.5, 2.0), "int8": (4 / 127, 6 / 127), "bf16": (1.0, 1.0)}[dtype_name]
    ks = np.linspace(*scales, Hk).astype(np.float32)
    vs = np.linspace(*scales[::-1], Hk).astype(np.float32)

    def arena(sc):
        x = rng.standard_normal((L, B, Hk, D, S)).astype(np.float32) / sc[None, None, :, None, None]
        if dtype_name == "int8":
            x = np.round(np.clip(x, -127, 127))
        elif dtype_name == "e4m3":
            x = np.clip(x, -448, 448)
        return jnp.asarray(x).astype(jdt)

    ka, va = arena(ks), arena(vs)
    q = jnp.asarray(rng.standard_normal((B, Hq, D)).astype(np.float32)).astype(jnp.bfloat16)
    nk = jnp.asarray(rng.standard_normal((B, Hk, D)).astype(np.float32)).astype(jnp.bfloat16)
    nv = jnp.asarray(rng.standard_normal((B, Hk, D)).astype(np.float32)).astype(jnp.bfloat16)
    lengths = np.asarray([1, 50, S], np.int32)
    ang = (lengths - 1)[:, None] * rng.uniform(0, 1, (1, D // 2)).astype(np.float32)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    return ka, va, q, nk, nv, lengths, cos, sin, ks, vs


def _to_port_layout(jax_arena):
    """[L, B, Hk, D, S] JAX arena → [L, B, Hk, S, D] torch tensor."""
    return _t(np.ascontiguousarray(np.asarray(jax_arena).transpose(0, 1, 2, 4, 3)))


@pytest.mark.parametrize("variant", ["plain", "window_softcap"])
@pytest.mark.parametrize("dtype_name", ["e4m3", "int8", "bf16"])
def test_arena_plain_matches_jax_kernel_and_appends_same_codes(dtype_name, variant):
    ka, va, q, nk, nv, lengths, cos, sin, ks, vs = _arena_case(dtype_name, 5)
    kw = {"window": 9, "softcap": 3.0} if variant == "window_softcap" else {}
    layer = 1
    ka_t, va_t = _to_port_layout(ka), _to_port_layout(va)
    ref, ka_j, va_j = jax_arena(q, ka, va, jnp.asarray(lengths), layer, new_k=nk, new_v=nv,
                                rope_cos_sin=(jnp.asarray(cos), jnp.asarray(sin)),
                                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                interpret=True, **kw)
    out, ka_t2, va_t2 = decode_attention_arena(
        _t(q), ka_t, va_t, torch.from_numpy(lengths), layer, new_k=_t(nk), new_v=_t(nv),
        rope_cos_sin=(torch.from_numpy(cos), torch.from_numpy(sin)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs), **kw)
    assert ka_t2 is ka_t and va_t2 is va_t  # updated in place
    np.testing.assert_array_equal(ka_t.view(torch.uint8).numpy(),
                                  _to_port_layout(ka_j).view(torch.uint8).numpy())
    np.testing.assert_array_equal(va_t.view(torch.uint8).numpy(),
                                  _to_port_layout(va_j).view(torch.uint8).numpy())
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))
    assert KERNEL_WRAPPERS["decode_attention_arena"].launches == 0  # CPU: plain version


def test_arena_attend_only_and_alibi_raises():
    ka, va, q, *_ , lengths, cos, sin, ks, vs = _arena_case("e4m3", 6)
    ref = jax_arena(q, ka, va, jnp.asarray(lengths), 0, k_scale=jnp.asarray(ks),
                    v_scale=jnp.asarray(vs), interpret=True)
    out = decode_attention_arena(_t(q), _to_port_layout(ka), _to_port_layout(va),
                                 torch.from_numpy(lengths), 0, k_scale=torch.from_numpy(ks),
                                 v_scale=torch.from_numpy(vs))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))
    # ALiBi is ported: attend-only with the slopes follows the JAX kernel,
    # and slopes for other than Hq heads raise.
    slopes = tuple(0.5 ** (i + 1) for i in range(q.shape[1]))
    ref = jax_arena(q, ka, va, jnp.asarray(lengths), 0, k_scale=jnp.asarray(ks),
                    v_scale=jnp.asarray(vs), alibi_slopes=slopes, interpret=True)
    out = decode_attention_arena(_t(q), _to_port_layout(ka), _to_port_layout(va),
                                 torch.from_numpy(lengths), 0, k_scale=torch.from_numpy(ks),
                                 v_scale=torch.from_numpy(vs), alibi_slopes=slopes)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))
    with pytest.raises(ValueError, match="alibi_slopes"):
        decode_attention_arena(_t(q), _to_port_layout(ka), _to_port_layout(va),
                               torch.from_numpy(lengths), alibi_slopes=(1.0,) * (q.shape[1] + 1))


@pytest.mark.parametrize("append", [False, True])
def test_arena_zero_length_gives_zeros_and_appends_nothing(append):
    """A zero-length sequence among the lengths: JAX's kernel runs no key
    chunk and returns 0 for its row, and so does the port. With a new token
    the port leaves that sequence's arena as it was (JAX's append at
    position -1 is an out-of-range tile copy, a port choice); the other
    sequences' outputs and appended codes are JAX's."""
    ka, va, q, nk, nv, _, cos, sin, ks, vs = _arena_case("e4m3", 7)
    lengths = np.asarray([0, 50, 128], np.int32)
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tkw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    if append:
        kw.update(new_k=nk, new_v=nv, rope_cos_sin=(jnp.asarray(cos), jnp.asarray(sin)))
        tkw.update(new_k=_t(nk), new_v=_t(nv),
                   rope_cos_sin=(torch.from_numpy(cos), torch.from_numpy(sin)))
    ref = jax_arena(q, ka, va, jnp.asarray(lengths), 1, interpret=True, **kw)
    ka_t, va_t = _to_port_layout(ka), _to_port_layout(va)
    ka0, va0 = ka_t.clone(), va_t.clone()
    out = decode_attention_arena(_t(q), ka_t, va_t, torch.from_numpy(lengths), 1, **tkw)
    if append:
        ref, ka_j, va_j = ref
        out = out[0]
        for got, before, jax_arena_out in ((ka_t, ka0, ka_j), (va_t, va0, va_j)):
            assert torch.equal(got[:, 0].view(torch.uint8), before[:, 0].view(torch.uint8))
            np.testing.assert_array_equal(
                got[:, 1:].view(torch.uint8).numpy(),
                _to_port_layout(jax_arena_out)[:, 1:].view(torch.uint8).numpy())
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(ref[0]).max() == 0.0
    assert out[0].abs().max().item() == 0.0
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))


@pytest.mark.parametrize("B,Hk,S,window", [
    (8, 8, 1024, None), (8, 8, 1024, 100), (1, 8, 1024, None), (2, 2, 128, None),
    (3, 8, 700, 100), (4, 4, 300, 50), (16, 8, 64, None), (1, 1, 5000, 1000), (2, 8, 33, 7)])
def test_arena_split_plan_partitions_every_length(B, Hk, S, window):
    """K2's split plan (computed on the host from the shapes alone): for
    every length the arena can hold, the splits' key ranges cover ``[0,
    length)`` (or the window's tail of it) exactly once, in order, and
    exactly one split holds position ``length - 1``, the one that appends.
    At the 1B decode shape the grid fills the 132 SMs four deep. (The
    ranges are K5's arithmetic with 32-key groups for pages.)"""
    from llm_fp8_tpu_torch.kernels.decode_attention import split_plan
    from llm_fp8_tpu_torch.kernels.paged_attention import split_ranges

    splits, span = split_plan(B, Hk, S, sms=132)
    assert split_plan(B, Hk, S, sms=132) == (splits, span)
    assert span % 32 == 0 and (splits - 1) * span < S <= splits * span
    assert splits == 1 or B * Hk * splits <= 4 * 132 or span == 32
    if (B, Hk, S) == (8, 8, 1024):
        assert (splits, span) == (8, 128)
    for length in sorted({n for n in (0, 1, 31, 32, 33, span - 1, span, span + 1, S // 2,
                                      S - 1, S) if 0 <= n <= S}):
        ranges = split_ranges(length, 32, splits, span // 32, window)
        start = max(0, length - window) if window else 0
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(start, length))
        holders = [z for z, (lo, hi) in enumerate(ranges) if lo <= length - 1 < hi]
        assert holders == ([] if length == 0 else [(length - 1) // span])


REF_CASES = {
    "causal_gqa": dict(causal=True),
    "offset_lens": dict(causal=True, q_offset=np.asarray([5, 9], np.int32),
                        kv_lens=np.asarray([20, 14], np.int32)),
    "window_softcap": dict(causal=True, window=5, softcap=4.0),
    "noncausal_lens": dict(causal=False, kv_lens=np.asarray([20, 3], np.int32)),
    "chunk": dict(causal=True, attention_chunk=4),
    "kv_start": dict(causal=True, q_offset=np.asarray([8, 8], np.int32),
                     kv_start=np.asarray([3, 0], np.int32),
                     kv_lens=np.asarray([20, 11], np.int32)),
}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_attention_ref_matches_jax(name):
    rng = np.random.default_rng(21)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    kw = REF_CASES[name]
    jkw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    tkw = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,softcap", [(None, None), (6, 3.0)])
def test_decode_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(22)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    pos = np.asarray([0, 10, 23], np.int32)
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(pos),
        kv_lens=jnp.asarray(pos + 1), window=window, softcap=softcap))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           q_offset=torch.from_numpy(pos), kv_lens=torch.from_numpy(pos + 1),
                           window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    # The dispatch sends Sq == 1 to decode_attention and Sq > 1 (CPU) to the reference.
    via = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    q_offset=torch.from_numpy(pos), kv_lens=torch.from_numpy(pos + 1),
                    window=window, softcap=softcap)
    np.testing.assert_array_equal(via.numpy(), got.numpy())


@pytest.mark.parametrize("kw", [dict(attention_chunk=8),
                                dict(kv_start=np.asarray([0, 4, 15], np.int32))],
                         ids=["chunk", "kv_start"])
def test_decode_attention_chunk_and_kv_start_match_jax(kw):
    rng = np.random.default_rng(23)
    q = rng.standard_normal((3, 1, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    pos = np.asarray([3, 10, 23], np.int32)
    jkw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    tkw = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b) for a, b in kw.items()}
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(pos),
        kv_lens=jnp.asarray(pos + 1), **jkw))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           q_offset=torch.from_numpy(pos), kv_lens=torch.from_numpy(pos + 1),
                           **tkw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
