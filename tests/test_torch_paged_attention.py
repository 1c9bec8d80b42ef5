"""K5, the paged decode attention, in the port against the JAX package.

The port's plain version (``paged_attention`` on CPU tensors) against the JAX
``paged_attention`` kernel in Pallas interpret mode, with the new token
appended, over e4m3, int8 and bf16 pools: the appended pool codes bit for
bit after carrying the JAX pools ``[P, L, Hk, D, page]`` into the port's
``[P, L, Hk, page, D]`` (``convert.pool_from_numpy``), and the outputs within
one bf16 ulp of the largest output. The cases cover GQA (8, 2) and (4, 1),
window with softcap, table padding of -1, a zero-length sequence and lengths
that end exactly on a page boundary.

Tolerance: where the JAX kernel's one tile of ``min(8, max_pages) · page``
keys covers the sequence, both sides compute the same float32 scores and
the same bf16-rounded p up to summation order, and both round the output to
bf16: one bf16 ulp. Across two tiles the JAX kernel rounds p against its
running maximum and the plain version against the global one: two ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.paged_attention import paged_attention as jax_paged
from llm_fp8_tpu_torch.convert import pool_from_numpy, pool_to_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.kernels import KERNEL_WRAPPERS
from llm_fp8_tpu_torch.kernels.paged_attention import paged_attention

_JDT = {"e4m3": jnp.float8_e4m3fn, "int8": jnp.int8, "bf16": jnp.bfloat16}
_KV_SCALE = {"e4m3": 0.5, "int8": 4 / 127, "bf16": 1.5}


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _case(dtype_name, seed, *, B, Hq, Hk, D=32, page=16, max_pages=4, L=2, lengths,
          pad=0):
    """Pools in the JAX layout with shuffled pages, tables padded with
    ``pad`` past each sequence's pages, and the decode inputs."""
    rng = np.random.default_rng(seed)
    kv_scale = _KV_SCALE[dtype_name]
    P = B * max_pages + 2

    def pool():
        x = rng.standard_normal((P, L, Hk, D, page)).astype(np.float32) / kv_scale
        if dtype_name == "int8":
            x = np.round(np.clip(x, -127, 127))
        elif dtype_name == "e4m3":
            x = np.clip(x, -448, 448)
        return jnp.asarray(x).astype(_JDT[dtype_name])

    kp, vp = pool(), pool()
    perm = rng.permutation(P)
    tables = np.full((B, max_pages), pad, np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(-(-n // page)):
            tables[b, i] = perm[nxt]
            nxt += 1
    q = jnp.asarray(rng.standard_normal((B, Hq, D)).astype(np.float32)).astype(jnp.bfloat16)
    nk = jnp.asarray(rng.standard_normal((B, Hk, D)).astype(np.float32)).astype(jnp.bfloat16)
    nv = jnp.asarray(rng.standard_normal((B, Hk, D)).astype(np.float32)).astype(jnp.bfloat16)
    return kp, vp, tables, q, nk, nv, np.asarray(lengths, np.int32), kv_scale


CASES = {
    # name: (case kwargs, attention kwargs)
    "gqa8_2": (dict(B=3, Hq=8, Hk=2, lengths=[16, 33, 64]), {}),
    "gqa4_1_zero_len_pad": (dict(B=3, Hq=4, Hk=1, lengths=[0, 1, 48], pad=-1), {}),
    "window_softcap": (dict(B=2, Hq=4, Hk=2, lengths=[40, 64]), dict(window=9, softcap=3.0)),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype_name", ["e4m3", "int8", "bf16"])
def test_plain_matches_jax_kernel_and_appends_same_codes(dtype_name, name):
    case_kw, kw = CASES[name]
    kp, vp, tables, q, nk, nv, lengths, kv_scale = _case(dtype_name, len(name), **case_kw)
    layer = 1
    ref, kp_j, vp_j = jax_paged(q, kp, vp, jnp.asarray(lengths), jnp.asarray(tables), layer,
                                kv_scale=kv_scale, new_k=nk, new_v=nv, interpret=True, **kw)
    kp_t, vp_t = pool_from_numpy(kp), pool_from_numpy(vp)
    out, kp_t2, vp_t2 = paged_attention(
        _t(q), kp_t, vp_t, torch.from_numpy(lengths), torch.from_numpy(tables), layer,
        kv_scale=kv_scale, new_k=_t(nk), new_v=_t(nv), **kw)
    assert kp_t2 is kp_t and vp_t2 is vp_t  # updated in place
    bits = np.uint16 if dtype_name == "bf16" else np.uint8
    np.testing.assert_array_equal(pool_to_numpy(kp_t), np.asarray(kp_j).view(bits))
    np.testing.assert_array_equal(pool_to_numpy(vp_t), np.asarray(vp_j).view(bits))
    changed = (np.asarray(kp_j).view(bits) != np.asarray(kp).view(bits)).any(axis=(1, 2, 3, 4))
    assert changed.sum() == int((lengths > 0).sum())  # one page per live sequence
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))
    if (lengths == 0).any():
        assert (out[lengths == 0] == 0).all()
    assert KERNEL_WRAPPERS["paged_attention"].launches == 0  # CPU: plain version


def test_two_tiles_and_attend_only():
    """A table wider than the TPU kernel's 8-page tile: two tiles on the JAX
    side, one maximum here (two-ulp tolerance); then attention without append."""
    kp, vp, tables, q, nk, nv, lengths, kv_scale = _case(
        "e4m3", 11, B=2, Hq=8, Hk=2, max_pages=12, lengths=[150, 192])
    ref, kp_j, _ = jax_paged(q, kp, vp, jnp.asarray(lengths), jnp.asarray(tables), 0,
                             kv_scale=kv_scale, new_k=nk, new_v=nv, interpret=True)
    kp_t, vp_t = pool_from_numpy(kp), pool_from_numpy(vp)
    out, _, _ = paged_attention(_t(q), kp_t, vp_t, torch.from_numpy(lengths),
                                torch.from_numpy(tables), 0, kv_scale=kv_scale,
                                new_k=_t(nk), new_v=_t(nv))
    np.testing.assert_array_equal(pool_to_numpy(kp_t), np.asarray(kp_j).view(np.uint8))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2 * _ulp(ref))
    ref = jax_paged(q, kp, vp, jnp.asarray(lengths - 5), jnp.asarray(tables), 1,
                    kv_scale=kv_scale, interpret=True)
    out = paged_attention(_t(q), pool_from_numpy(kp), pool_from_numpy(vp),
                          torch.from_numpy(lengths - 5), torch.from_numpy(tables), 1,
                          kv_scale=kv_scale)
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2 * _ulp(ref))


@pytest.mark.parametrize("bad", ["alibi", "page_size", "groups", "dtype"])
def test_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((2, 4, 32), dtype=torch.bfloat16)
    pool = torch.zeros((5, 1, 2, 16, 32), dtype=torch.float8_e4m3fn)
    lengths, tables = torch.tensor([3, 4]), torch.zeros((2, 2), dtype=torch.int32)
    kw = {}
    if bad == "alibi":  # ALiBi is ported: slopes for other than Hq heads are refused
        kw["alibi_slopes"] = (1.0,) * 5
    elif bad == "page_size":
        pool = torch.zeros((5, 1, 2, 24, 32), dtype=torch.float8_e4m3fn)
    elif bad == "groups":
        q = torch.zeros((2, 18, 32), dtype=torch.bfloat16)
    else:
        pool = pool.float()
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err):
        paged_attention(q, pool, pool.clone(), lengths, tables, **kw)


@pytest.mark.parametrize("B,Hk,max_pages,page,window", [
    (8, 8, 65, 128, None), (1, 8, 65, 128, None), (2, 2, 3, 16, None), (16, 8, 1, 32, None),
    (4, 4, 100, 16, 100), (8, 8, 9, 128, None), (1, 1, 1000, 16, None)])
def test_split_plan_partitions_every_length(B, Hk, max_pages, page, window):
    """The CUDA kernel's split plan (computed on the host from the shapes):
    for every length the table can hold, the splits' key ranges partition
    ``[0, length)`` (or the window's tail of it) in order, and exactly one
    split holds position ``length - 1``, the one that appends."""
    from llm_fp8_tpu_torch.kernels.paged_attention import split_plan, split_ranges

    splits, per = split_plan(B, Hk, max_pages, sms=132)
    assert split_plan(B, Hk, max_pages, sms=132) == (splits, per)
    assert 1 <= splits <= max_pages and (splits - 1) * per < max_pages <= splits * per
    assert splits == 1 or B * Hk * splits >= 132 or splits * per == max_pages
    cap = max_pages * page
    for length in sorted({n for n in (0, 1, page - 1, page, page + 1, cap // 2, cap - 1, cap)
                          if n <= cap}):
        ranges = split_ranges(length, page, splits, per, window)
        start = max(0, length - window) if window else 0
        covered = [t for lo, hi in ranges for t in range(lo, hi)]
        assert covered == list(range(start, length))
        holders = [z for z, (lo, hi) in enumerate(ranges) if lo <= length - 1 < hi]
        assert holders == ([] if length == 0 else [(length - 1) // (per * page)])
