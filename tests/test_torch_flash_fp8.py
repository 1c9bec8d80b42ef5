"""K7 in the port (``kernels/flash_attention.py::flash_attention_fp8``)
against the JAX package's ``flash_attention_fp8``.

On CPU tensors the port takes its plain version (``flash_fp8_plain``), which
walks the ``block_k`` key tiles as the TPU kernel does; the JAX side runs the
Pallas kernel in interpret mode on both of its routes (``fp8_native`` True
and False). Inputs are quantized per kv head with numpy, as
``tests/test_flash_attention.py::TestFP8Compute._quantize_per_kvhead`` does,
at that class's shapes.

Tolerance: rtol = atol = 6e-3, a tenth of the JAX test's 6e-2 against its
float32 reference. Readings (``tests/torch_parity_readings.py``,
``flash_fp8``): the port's plain version matches both JAX routes to 4.8e-7 in
float32 out and exactly in bf16, except where a score's float32 sum order
flips one e4m3 code of P (one element of one row at ``block_k`` 128: 5.0e-4
float32, 2.0e-3 bf16). A plain version that keeps P in bf16 breaks the
tolerance at every shape (by 1.9e-3 at least, at decode), and so does a
128-key tile where the function's tile is 256 (by 6.2e-3 without causality;
with it, the 128 queries never reach the second 128 keys and the tiles
agree).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.flash_attention import flash_attention_fp8 as jax_fp8
from llm_fp8_tpu_torch.kernels import flash_attention as k7
from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
from llm_fp8_tpu_torch.kernels.flash_attention import auto_block, flash_attention_fp8

TOL = 6e-3

CASES = {
    # name: (seed, B, Sq, Sk, Hq, Hk, D, kwargs, decode lengths)
    "causal": (40, 2, 128, 256, 4, 2, 64, {"causal": True}, None),
    "not_causal": (40, 2, 128, 256, 4, 2, 64, {"causal": False}, None),
    "decode": (42, 2, 1, 256, 4, 2, 64, {"causal": True}, [201, 128]),
    "window_softcap": (43, 2, 128, 256, 4, 2, 64,
                       {"causal": True, "window": 50, "softcap": 3.0}, None),
    "block_k_128": (44, 2, 128, 256, 4, 2, 64, {"causal": True, "block_k": 128}, None),
    "block_k_256": (45, 2, 128, 256, 4, 2, 64, {"causal": False, "block_k": 256}, None),
}


def quantize_per_kvhead(x: np.ndarray, Hk: int):
    """``[B, S, H, D]`` float32 → e4m3 codes (uint8) and ``[B, Hk]`` descales
    (amax over the kv head's group / 448)."""
    B, S, H, D = x.shape
    xg = x.reshape(B, S, Hk, H // Hk, D)
    descale = (np.abs(xg).max(axis=(1, 3, 4)) / 448.0).astype(np.float32)
    codes = np.array(jnp.asarray(xg / descale[:, None, :, None, None])
                       .astype(jnp.float8_e4m3fn)).reshape(B, S, H, D)
    return codes.view(np.uint8), descale


def _inputs(name):
    seed, B, Sq, Sk, Hq, Hk, D, kw, lens = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))
    qkv = [quantize_per_kvhead(t, Hk) for t in (q, k, v)]
    kw = dict(kw)
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        kw.update(q_offset=lens - 1, kv_lens=lens)
    return qkv, kw


def _jax(qkv, kw, native, out_dtype):
    (q8, qd), (k8, kd), (v8, vd) = qkv
    j = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    out = jax_fp8(*(jnp.asarray(c.view(jnp.float8_e4m3fn)) for c in (q8, k8, v8)),
                  q_descale=jnp.asarray(qd), k_descale=jnp.asarray(kd),
                  v_descale=jnp.asarray(vd), fp8_native=native, out_dtype=out_dtype,
                  interpret=True, **j)
    return np.asarray(out.astype(jnp.float32))


def _port(qkv, kw, out_dtype, fn=flash_attention_fp8):
    (q8, qd), (k8, kd), (v8, vd) = qkv
    p = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_) for k_, v_ in kw.items()}
    codes = (torch.from_numpy(c).view(torch.float8_e4m3fn) for c in (q8, k8, v8))
    return fn(*codes, q_descale=torch.from_numpy(qd), k_descale=torch.from_numpy(kd),
              v_descale=torch.from_numpy(vd), out_dtype=out_dtype, **p)


def _excess(got: torch.Tensor, want: np.ndarray) -> float:
    """Largest ``|got - want| - TOL·(1 + |want|)``: at most 0 within tolerance."""
    return float((np.abs(got.float().numpy() - want) - TOL * (1.0 + np.abs(want))).max())


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "dequant"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_k7_matches_both_jax_routes(name, native, out):
    qkv, kw = _inputs(name)
    jd, td = (jnp.float32, torch.float32) if out == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax(qkv, kw, native, jd)
    reset_launch_counts()
    got = _port(qkv, kw, td)
    assert all(n == 0 for n in launch_counts().values())  # CPU: the plain version
    assert got.dtype == td and got.shape == want.shape
    assert _excess(got, want) <= 0.0


def tile_walk(q, k, v, *, q_descale, k_descale, v_descale, causal=True, window=None,
              softcap=None, q_offset=0, kv_lens=None, block_k=None, out_dtype, p_dtype):
    """K7's tile walk written out apart from the port, with P rounded to
    ``p_dtype`` before the PV product: e4m3 gives the kernel's function, any
    other type a wrong version on purpose. Descales are ``[B, Hk]``."""
    B, Sq, Hq, D = q.shape
    Sk, g = k.shape[1], Hq // k.shape[2]
    qf, kf, vf = (t.float().permute(0, 2, 1, 3).repeat_interleave(Hq // t.shape[2], dim=1)
                  for t in (q, k, v))
    qkd = (q_descale * k_descale).repeat_interleave(g, dim=1)[:, :, None, None]
    vd = v_descale.repeat_interleave(g, dim=1)[:, :, None, None]
    q_pos = (torch.as_tensor(q_offset).long().reshape(-1, 1) + torch.arange(Sq))[:, None, :, None]
    lens = (torch.full((B,), Sk) if kv_lens is None else kv_lens.long())[:, None, None, None]
    m = torch.full((B, Hq, Sq, 1), -float("inf"))
    l, acc = torch.zeros((B, Hq, Sq, 1)), torch.zeros((B, Hq, Sq, D))
    block_k = block_k or auto_block(Sk)
    for k0 in range(0, Sk, block_k):
        s = (qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * D ** -0.5 * qkd
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + s.shape[-1])[None, None, None, :]
        mask = (k_pos < lens) & ((k_pos <= q_pos) if causal else True)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, torch.full_like(s, k7.MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp(m - m_next), torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(p_dtype).float() @ vf[:, :, k0:k0 + block_k]
        m = m_next
    dead = (l == 0.0) | (m <= k7.MASK_VALUE * 0.5)
    out = torch.where(dead, 0.0, acc * (1.0 / torch.where(dead, 1.0, l))) * vd
    return out.to(out_dtype).permute(0, 2, 1, 3)


@pytest.mark.parametrize("name", list(CASES))
def test_a_bf16_p_breaks_the_tolerance(name):
    # FA3's P is e4m3; a version that keeps it in bf16 is another function.
    # The walk with e4m3 P is the port's plain version exactly, so only the
    # P type sets the two apart.
    qkv, kw = _inputs(name)
    want = _jax(qkv, kw, False, jnp.float32)
    same = _port(qkv, kw, torch.float32, fn=lambda *a, **k: tile_walk(
        *a, **k, p_dtype=torch.float8_e4m3fn))
    assert torch.equal(same, _port(qkv, kw, torch.float32))
    bad = _port(qkv, kw, torch.float32, fn=lambda *a, **k: tile_walk(
        *a, **k, p_dtype=torch.bfloat16))
    assert _excess(bad, want) > 0.0


def test_the_key_tile_is_part_of_the_function():
    # With block_k 128 where JAX's tile is 256, P's e4m3 codes follow other
    # running maxima: the tolerance tells the two apart.
    qkv, kw = _inputs("not_causal")
    want = _jax(qkv, kw, False, jnp.float32)
    assert auto_block(256) == 256 and auto_block(8192) == 512 and auto_block(1) == 128
    assert _excess(_port(qkv, kw, torch.float32), want) <= 0.0
    assert _excess(_port(qkv, {**kw, "block_k": 128}, torch.float32), want) > 0.0


def test_descale_shapes_and_input_checks():
    qkv, kw = _inputs("causal")
    (q8, qd), (k8, kd), (v8, vd) = qkv
    full = _port(qkv, kw, torch.float32)
    # [Hk] descales broadcast over the batch, as JAX's as_bh.
    per_head = [(c, d[0]) for c, d in qkv]
    one_row = [(c[:1], d) for c, d in per_head]
    a = _port(one_row, kw, torch.float32)
    assert torch.equal(a, full[:1])
    t = torch.from_numpy(q8).view(torch.float8_e4m3fn)
    # One kv length per batch row: the kernel reads kv_lens[b].
    with pytest.raises(ValueError, match="kv_lens"):
        _port(qkv, {**kw, "kv_lens": np.asarray([256], np.int32)}, torch.float32)
    with pytest.raises(TypeError):
        flash_attention_fp8(t.float(), t, t, q_descale=1.0, k_descale=1.0, v_descale=1.0)
    with pytest.raises(TypeError):
        flash_attention_fp8(t, t, t, q_descale=1.0, k_descale=1.0, v_descale=1.0,
                            out_dtype=torch.float16)


@pytest.mark.parametrize("Sk", [1, 31, 64, 200, 256])
def test_prepass_widens_q_k_and_puts_each_v_key_in_its_slot(Sk):
    # The wgmma route's pre-pass: q and k in bf16, exactly; V as [B, Hk, D,
    # Skp] with slot j of a 32-key group holding key 16h + 2t + (u & 1) +
    # 8 (u >> 1) (j = 16h + 4t + u), zeros past Sk. On CPU tensors the
    # wrapper is the plain version.
    rng = np.random.default_rng(Sk)
    v = torch.from_numpy(rng.integers(1, 127, (2, Sk, 3, 32), dtype=np.uint8)).view(
        torch.float8_e4m3fn)
    q = torch.from_numpy(rng.integers(0, 256, (2, 5, 6, 32), dtype=np.uint8)).view(
        torch.float8_e4m3fn)
    qb, kb, vt = k7.fp8_prepass(q, v, v)
    for codes, wide in ((q, qb), (v, kb)):
        assert wide.dtype == torch.bfloat16
        want = codes.float()
        assert torch.equal(wide.float().isnan(), want.isnan())
        assert torch.equal(wide.float().nan_to_num(), want.nan_to_num())
    Skp = -(-Sk // 32) * 32
    assert vt.shape == (2, 3, 32, Skp) and vt.dtype == torch.float8_e4m3fn
    codes, got = v.view(torch.uint8), vt.view(torch.uint8)
    for j in range(Skp):
        h, t, u = j % 32 // 16, j % 16 // 4, j % 4
        key = j // 32 * 32 + 16 * h + 2 * t + (u & 1) + 8 * (u >> 1)
        want = codes[:, key] if key < Sk else torch.zeros_like(got[..., j])
        assert torch.equal(got[..., j], want), (j, key)


def test_p_codes_meet_their_v_rows():
    # The kernel packs p8 straight from the scores' accumulator into P·V's A
    # fragment: accumulator element i of lane t is key 8 (i >> 2) + 2t + (i & 1)
    # of its 64-key chunk (rows gid and gid + 8 by (i >> 1) & 1); register rr
    # of k-step kk takes elements i_a, i_a + 1, i_a + 4, i_a + 5 with
    # i_a = 16kk + 8 (rr >> 1) + 2 (rr & 1), as A slots 32kk + 16 (rr >> 1) +
    # 4t + byte. Each slot must hold the key whose V row the pre-pass put there.
    slot_key = k7._slot_keys().tolist()
    for t in range(4):
        for kk in range(2):
            for rr in range(4):
                i_a = 16 * kk + 8 * (rr >> 1) + 2 * (rr & 1)
                for byte, i in enumerate((i_a, i_a + 1, i_a + 4, i_a + 5)):
                    key = 8 * (i >> 2) + 2 * t + (i & 1)
                    row = (i >> 1) & 1
                    assert row == (rr & 1)
                    slot = 16 * (rr >> 1) + 4 * t + byte
                    assert key == 32 * kk + slot_key[slot], (t, kk, rr, byte)


def test_wgmma_route_takes_what_it_can():
    # The native route from one 64-row query tile up, while two stages of a
    # block_k tile of K and Vᵀ fit in shared memory; else the mma.sync kernel.
    assert k7.fp8_wgmma_ok(8192, 64, 512, True)
    assert k7.fp8_wgmma_ok(100, 128, 256, True) and k7.fp8_wgmma_ok(64, 32, 1024, True)
    assert not k7.fp8_wgmma_ok(8192, 64, 512, False)
    assert not k7.fp8_wgmma_ok(63, 64, 512, True) and not k7.fp8_wgmma_ok(1, 64, 512, True)
    assert not k7.fp8_wgmma_ok(8192, 128, 512, True)
