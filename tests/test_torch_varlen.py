"""Packing, split-KV and the masks they need, in the port against the JAX
package, on the CPU.

* ``unpad_input``/``pad_input``/``cu_seqlens``/``pack_sequences`` bit for bit
  with JAX's (``ops/varlen.py``).
* K3 and K6 (their plain versions behind ``flash_attention`` on CPU tensors)
  with ``attention_chunk`` and segment ids: against JAX's ``flash_attention``
  and its VJP in Pallas interpret mode at one small bf16 shape (within 4 bf16
  ulps of each tensor's largest |value|, the LSE to rtol 1e-5), and against
  JAX's float32 golden ``attention_ref`` and ``jax.vjp`` of it elsewhere, at
  bf16 and float32, with GQA, ``q_offset`` and both causal and not (bf16: 2
  ulps forward, the JAX package's bf16 gradient tolerance rtol = atol =
  2e-2; float32: 1e-5 forward and 1e-4 gradients of the largest |value|,
  sum orders).
* Head dim 16 (debug-vit) runs zero-padded onto the 32 instance and equals
  the unpadded golden at the unpadded scale, forward and gradients.
* A packed stream through K3 with segment ids equals each sequence attended
  alone; a negative ``q_offset`` leaves rows with no key at out 0, LSE -inf.
* ``split_kv_attention``, ``combine_partials``, ``auto_num_splits`` and
  ``decode_attention(num_splits=)`` against JAX's, on the cases of
  ``tests/test_split_kv.py`` (the split attention at a smaller shape, since
  JAX's runs its flash kernel in interpret mode): float32 sum orders, rtol
  1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.flash_attention import _flash_fwd_call
from llm_fp8_tpu.kernels.flash_attention import flash_attention as jax_flash
from llm_fp8_tpu.ops import split_kv as jsplit
from llm_fp8_tpu.ops import varlen as jvarlen
from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from llm_fp8_tpu.ops.attention import decode_attention as jax_decode_attention
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels.flash_attention import flash_attention
from llm_fp8_tpu_torch.ops import split_kv, varlen
from llm_fp8_tpu_torch.ops.attention import attention_ref, decode_attention

torch.set_num_threads(1)  # one thread per xdist worker (see test_torch_zoo_models.py)


def _ulps(ref, n):
    top = np.abs(ref).max()
    return 0.0 if top == 0 else n * 2.0 ** (np.floor(np.log2(top)) - 7)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _packed_ids(B, S, lens_per_row):
    """Segment ids ``[B, S]`` from ``pack_sequences`` of the given lengths
    (each row's tail past its sequences is id 0)."""
    return np.stack([jvarlen.pack_sequences([np.zeros(n, np.int32) for n in lens], S)[1]
                     for lens in lens_per_row[:B]])


# ---------------------------------------------------------------- varlen ---


def test_varlen_helpers_match_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 2, 5)).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([7, 2, 4])[:, None]).astype(np.int32)
    mask[2, 1] = 0  # a hole: stable order must still hold
    jp, ji, jn = jvarlen.unpad_input(jnp.asarray(x), jnp.asarray(mask))
    tp, ti, tn = varlen.unpad_input(torch.from_numpy(x), torch.from_numpy(mask))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and int(tn) == int(jn) == 12
    jr = jvarlen.pad_input(jp, ji, 3, 7)
    tr = varlen.pad_input(tp, ti, 3, 7)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(varlen.cu_seqlens([3, 2, 5]), jvarlen.cu_seqlens([3, 2, 5]))
    assert varlen.cu_seqlens([3, 2, 5]).dtype == np.int32
    seqs = [rng.integers(1, 500, n).astype(np.int32) for n in (3, 2, 10, 1)]
    for total in (8, 5, 20):
        for a, b in zip(varlen.pack_sequences(seqs, total, pad_id=7),
                        jvarlen.pack_sequences(seqs, total, pad_id=7)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------- K3/K6 chunk and segments ---


def test_chunk_and_segments_match_jax_flash_in_interpret_mode():
    """bf16, B 1, 96 rows, 4 q heads over 2, D 32, causal, three packed
    sequences and a padding tail, chunk 32: out, LSE and the VJP."""
    B, S, Hq, Hk, D, C = 1, 96, 4, 2, 32, 32
    rng = np.random.default_rng(3)
    q, k, v, do = (jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jnp.bfloat16)
                   for s in ((B, S, Hq, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, Hq, D)))
    seg = _packed_ids(B, S, [[40, 30, 17]])
    q_off, kv = np.zeros(B, np.int32), np.full(B, S, np.int32)
    jseg = jnp.asarray(seg)
    ref, ref_lse = jax.jit(_flash_fwd_call, static_argnames=(
        "causal", "window", "softcap", "scale", "block_q", "block_k", "interpret",
        "attention_chunk"))(q, k, v, jnp.asarray(q_off), jnp.asarray(kv), jseg, jseg,
                            causal=True, window=None, softcap=None, scale=D ** -0.5,
                            block_q=128, block_k=128, interpret=True, attention_chunk=C)

    def loss(q, k, v):
        out = jax_flash(q, k, v, q_segment_ids=jseg, kv_segment_ids=jseg, attention_chunk=C,
                        interpret=True)
        return jnp.sum(out.astype(jnp.float32) * do.astype(jnp.float32))

    grads = [np.asarray(g.astype(jnp.float32))
             for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    tseg = torch.from_numpy(seg)
    out, lse = flash_attention(qt, kt, vt, q_segment_ids=tseg, kv_segment_ids=tseg,
                               attention_chunk=C, return_lse=True)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().detach().numpy(), ref, rtol=0, atol=_ulps(ref, 4))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[:, :, 0, :S], rtol=1e-5)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    for name, g, r in zip("qkv", got, grads):
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=_ulps(r, 4),
                                   err_msg=f"d{name}")


MASK_CASES = {
    # name: (dtype, B, Sq, Sk, Hq, Hk, causal, q_offset, kv_lens, chunk, segments)
    "chunk_bf16_gqa_offset": ("bf16", 2, 24, 64, 8, 2, True, [40, 20], [64, 44], 16, False),
    "chunk_f32_noncausal": ("f32", 2, 40, 40, 4, 2, False, [0, 0], [40, 29], 12, False),
    "segments_bf16_causal": ("bf16", 2, 48, 48, 4, 1, True, [0, 0], [48, 48], None, True),
    "segments_f32_noncausal": ("f32", 2, 48, 48, 4, 4, False, [0, 0], [48, 40], None, True),
    "both_f32_gqa": ("f32", 1, 64, 64, 8, 2, True, [0], [64], 16, True),
}


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_chunk_and_segments_match_the_jax_golden(name):
    dt, B, Sq, Sk, Hq, Hk, causal, q_off, kv, chunk, segs = MASK_CASES[name]
    D = 32
    rng = np.random.default_rng(len(name))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D), (B, Sq, Hq, D)))
    if dt == "bf16":  # both sides see the same bf16 values
        q, k, v, do = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                       for a in (q, k, v, do))
    kw = dict(causal=causal, attention_chunk=chunk)
    tkw = dict(kw, q_offset=torch.tensor(q_off, dtype=torch.int32),
               kv_lens=torch.tensor(kv, dtype=torch.int32))
    jkw = dict(kw, q_offset=jnp.asarray(q_off, jnp.int32), kv_lens=jnp.asarray(kv, jnp.int32))
    if segs:
        ids = _packed_ids(B, Sq, [[20, 17, 5], [30, 9]])
        tkw.update(q_segment_ids=torch.from_numpy(ids), kv_segment_ids=torch.from_numpy(ids))
        jkw.update(q_segment_ids=jnp.asarray(ids), kv_segment_ids=jnp.asarray(ids))
    want, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(q, k, v, **jkw),
                        *(jnp.asarray(a) for a in (q, k, v)))
    want = np.asarray(want)
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, **tkw)
    got_g = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt))
    if dt == "bf16":
        np.testing.assert_allclose(out.float().detach().numpy(), want, rtol=0,
                                   atol=_ulps(want, 2))
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2, atol=2e-2)
    else:
        top = np.abs(want).max()
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5 * top)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    # The port's golden takes the same masks.
    gold = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    np.testing.assert_allclose(gold.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_16_equals_the_unpadded_golden(dtype):
    """debug-vit's 4 heads of 16, non-causal over 17 rows (1 + 16 patches)."""
    rng = np.random.default_rng(16)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 17, 4, 16)).astype(np.float32))
                   for _ in range(4))
    q, k, v, do = (t.to(dtype).float() for t in (q, k, v, do))
    leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    lens = torch.tensor([17, 11], dtype=torch.int32)
    out = flash_attention(*leaves, causal=False, kv_lens=lens)
    assert out.shape == (2, 17, 4, 16) and out.dtype == dtype
    got = torch.autograd.grad(out, leaves, do.to(dtype))
    f32 = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention_ref(*f32, causal=False, kv_lens=lens)  # scale 16 ** -0.5
    want_g = torch.autograd.grad(want, f32, do)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6 * want.abs().max().item())
        for g, w in zip(got, want_g):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * w.abs().max().item())
    else:
        np.testing.assert_allclose(out.float().detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=_ulps(want.detach().numpy(), 2))
        for g, w in zip(got, want_g):
            np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2, atol=2e-2)


def test_packed_stream_equals_each_sequence_alone():
    """Three sequences packed by ``pack_sequences`` into one row of 64 and
    attended causally with their segment ids give what each gives alone."""
    lens, S, H, D = (23, 30, 6), 64, 2, 32
    rng = np.random.default_rng(9)
    qkv = [torch.from_numpy(rng.standard_normal((1, S, H, D)).astype(np.float32)).bfloat16()
           for _ in range(3)]
    _, seg, pos = varlen.pack_sequences([np.zeros(n, np.int32) for n in lens], S)
    seg = torch.from_numpy(seg)[None]
    out = flash_attention(*qkv, q_segment_ids=seg, kv_segment_ids=seg)
    start = 0
    for n in lens:
        alone = flash_attention(*(t[:, start:start + n] for t in qkv))
        assert torch.equal(out[:, start:start + n], alone)
        assert (pos[start:start + n] == np.arange(n)).all()
        start += n


def test_negative_q_offset_gives_dead_rows():
    """Split-KV's later chunks: queries at q_offset -40 see no key of a
    32-key chunk under causal masking (out 0, LSE -inf); at -8 the first 8
    rows are dead and the rest are live."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 16, 2, 32)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 32)).astype(np.float32)).bfloat16()
    out, lse = flash_attention(q, k, k, q_offset=torch.tensor([-40, -8], dtype=torch.int32),
                               return_lse=True)
    assert (out[0] == 0).all() and torch.isneginf(lse[0]).all()
    assert (out[1, :8] == 0).all() and torch.isneginf(lse[1, :, :8]).all()
    assert torch.isfinite(lse[1, :, 8:]).all()


# -------------------------------------------------------------- split-KV ---


def _mk(seed, B, Sq, Sk, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))


@pytest.mark.parametrize("num_splits", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_split_kv_attention_matches_jax(num_splits, causal):
    q, k, v = _mk(0, 2, 32, 128, 4, 2, 32)
    want = jsplit.split_kv_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     num_splits=num_splits, causal=causal)
    got = split_kv.split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                      num_splits=num_splits, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    one = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)


def test_split_kv_decode_with_ragged_lens_matches_jax():
    q, k, v = _mk(1, 3, 1, 128, 4, 2, 32)
    lens = np.array([20, 75, 128], np.int32)
    want = jsplit.split_kv_attention(*(jnp.asarray(a) for a in (q, k, v)), num_splits=4,
                                     causal=True, q_offset=jnp.asarray(lens - 1),
                                     kv_lens=jnp.asarray(lens))
    got = split_kv.split_kv_attention(*(torch.from_numpy(a) for a in (q, k, v)), num_splits=4,
                                      causal=True, q_offset=torch.from_numpy(lens - 1),
                                      kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_combine_partials_matches_jax():
    rng = np.random.default_rng(2)
    outs = rng.standard_normal((3, 2, 4, 2, 8)).astype(np.float32)
    lses = rng.standard_normal((3, 2, 4, 2)).astype(np.float32)
    lses[1, 0] = -np.inf          # an empty chunk
    lses[:, 1, 2] = -np.inf       # a row every chunk leaves empty: 0
    want = np.asarray(jsplit.combine_partials(jnp.asarray(outs), jnp.asarray(lses)))
    got = split_kv.combine_partials(torch.from_numpy(outs), torch.from_numpy(lses)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[1, 2] == 0).all()


@pytest.mark.parametrize("feature", ["plain", "ragged", "window", "softcap", "alibi", "chunk"])
def test_decode_split_matches_jax(feature):
    rng = np.random.default_rng(7)
    B, S, Hq, Hk, D = 3, 256, 4, 2, 32
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    lens = np.array([100, 170, 256], np.int32)
    kw = dict(q_offset=lens - 1, kv_lens=lens)
    if feature == "window":
        kw["window"] = 64
    elif feature == "softcap":
        kw["softcap"] = 20.0
    elif feature == "alibi":
        kw["alibi_slopes"] = rng.uniform(0.01, 0.2, Hq).astype(np.float32)
    elif feature == "chunk":
        kw["attention_chunk"] = 64
    elif feature == "ragged":
        kw["kv_lens"] = np.array([1, 130, 250], np.int32)
        kw["q_offset"] = kw["kv_lens"] - 1

    def conv(f):
        return {n: f(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}

    want = np.asarray(jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v)), num_splits=4,
                                           **conv(jnp.asarray)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = decode_attention(tq, tk, tv, num_splits=4, **conv(torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    unsplit = decode_attention(tq, tk, tv, **conv(torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, unsplit, rtol=1e-5, atol=1e-5)
    auto = decode_attention(tq, tk, tv, num_splits="auto", **conv(torch.from_numpy)).numpy()
    assert np.array_equal(auto, unsplit)  # "auto" resolves to 1 here
    with pytest.raises(ValueError, match="divide"):
        decode_attention(tq, tk, tv, num_splits=3, **conv(torch.from_numpy))


def test_auto_num_splits_matches_jax():
    for args, cores in [((1, 8, 16384), 1), ((8, 8, 16384), 1), ((4, 8, 16384), 2),
                        ((1, 1, 16384), 2), ((1, 1, 1024), 2), ((1, 1, 4096), 16),
                        ((1, 1, 65536), 64), ((2, 4, 32768), 132)]:
        assert (split_kv.auto_num_splits(*args, num_cores=cores)
                == jsplit.auto_num_splits(*args, num_cores=cores))
    assert split_kv.auto_num_splits(1, 1, 65536) == 1  # no core count: no split
