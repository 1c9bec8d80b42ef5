"""K6 at float32 (the GPT-2 and NeoX families train in float32), checked
without a card through its plain version.

* The repair of the plain K6: it rounds p and ds to q's dtype, as JAX's K6
  (``astype(q.dtype)`` at ``llm_fp8_tpu/kernels/flash_attention_bwd.py``
  ``:148-153,207``), where it rounded them to bf16 always. At float32,
  ``flash_attention(...)``'s backward on the CPU lies within float32 noise
  of float64 autograd: at most 2^-17 of each row's largest |grad|, a row
  whose largest |grad| lies below 2^-5 of the tensor's largest held against
  that floor (a query that sees one key has dq = 0 exactly, and a few that
  see two have dq ~1% of the others: there the row's own size is float32
  cancellation, not the gradient's scale). Before the repair it read
  1.0-1.8e-3. At bf16 the plain backward is unchanged bit for bit: every
  bf16 K6 check of ``chip_smoke.py`` rests on it.
* The plain float32 K6 against ``jax.grad`` of JAX's reference ``attention``
  in float32: multi-query (4 q heads over 1), ALiBi with the scale 1/D, and
  dropout 0.1 (JAX's reference attention draws the same counter hash); dq
  within 2^-14 and dk, dv within 2^-16 of each row's largest |grad|
  (floored as above).
* ``F32_GRAD_TOL`` (``chip_smoke.py``: 2^-12 of each row's largest |grad|,
  floored as above), the tolerance the card's K6 float32 instance is held
  to against its plain version, reproduced against an emulation of its
  products: 3xTF32 (each operand split into big and small TF32 parts, three
  products) stays within 2^-14 of the plain float32 version, and
  single-pass TF32 breaks 2^-12 in nearly every dq row (the S recompute's
  TF32 error goes through exp). On an H100 the kernel read up to 1.35 x
  2^-14 (dq, head dim 256); its float32 sums are flushed a tile at a time
  (the tensor cores' accumulation drops low bits: before that flush dK and
  dV read 3.7 x 2^-14 at Falcon-7B's 71 q heads over one kv head).
* The same separation in the kernels' order of sums: a key or query tile's
  product at a time, the GQA group split into the slices of the dKV plan
  (``dkv_slices``) and summed in slice order; and the plan itself (slices
  that divide the group, enough blocks for the card at SantaCoder's and
  Falcon-7B's shapes, the scratch's shape).
* The wrapper on CPU tensors takes the plain version; the float32 forward
  takes dropout (its plain version on the CPU) and its autograd backward
  is the plain K6 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.ops.attention import attention as jax_attention
from llm_fp8_tpu.ops.attention import default_alibi_slopes as jax_slopes
from llm_fp8_tpu_torch.kernels._common import alibi_bias
from llm_fp8_tpu_torch.kernels.flash_attention import flash_attention, flash_fwd_plain
from llm_fp8_tpu_torch.kernels.flash_attention_bwd import (DKV_TARGET_BLOCKS, dkv_keys,
                                                           dkv_scratch_shape, dkv_slices,
                                                           flash_attention_bwd,
                                                           flash_attention_bwd_f32,
                                                           flash_attention_bwd_plain,
                                                           recompute_p_ds, row_di)
from llm_fp8_tpu_torch.ops.attention import attention_ref

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

FLOOR = 2.0 ** -5  # chip_smoke.py::F32_GRAD_FLOOR
GRAD_TOL = 2.0 ** -12  # chip_smoke.py::F32_GRAD_TOL


def _inputs(B, S, Hq, Hk, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, Hq, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, Hq, D))]


def _row_err(got, ref):
    """Each row's largest error over max(its largest |ref|, FLOOR · the
    tensor's largest |ref|)."""
    ref = ref.double()
    scale = torch.maximum(ref.abs().amax(dim=-1), FLOOR * ref.abs().max())
    return (got.double() - ref).abs().amax(dim=-1) / scale


def _slopes(H, B):
    return torch.tensor(np.asarray(jax_slopes(H)))[None].expand(B, H).contiguous()


def test_plain_float32_backward_is_within_float32_noise_of_float64():
    q, k, v, do = _inputs(1, 64, 4, 2, 32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, causal=True), leaves, do)
    leaves64 = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves64, causal=True), leaves64, do.double())
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32
        assert float(_row_err(a, b).max()) <= 2.0 ** -17, f"d{name}"


def test_plain_bf16_backward_is_unchanged_bit_for_bit():
    """The bf16 plain backward rounds p and ds to bf16 before the dV, dK and
    dQ products, exactly as before the repair (its formula written out)."""
    q, k, v, do = (t.to(torch.bfloat16) for t in _inputs(2, 48, 4, 2, 32, seed=3))
    B, S, Hq, D = q.shape
    qo = torch.tensor([0, 5], dtype=torch.int32)
    kl = torch.tensor([48, 40], dtype=torch.int32)
    cfg = dict(causal=True, window=None, softcap=None, scale=D ** -0.5,
               alibi=_slopes(Hq, B), dropout_p=0.1, dropout_seed=7)
    o, lse = flash_fwd_plain(q, k, v, qo, kl, **cfg)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, q_offset=qo, kv_lens=kl, **cfg)
    p, ds = recompute_p_ds(q, k, v, lse, do, row_di(o, do), qo, kl, **cfg)
    pb, dsb = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    g = Hq // k.shape[2]
    qf, dof = q.float().permute(0, 2, 1, 3), do.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    dv = (pb.transpose(-1, -2) @ dof).reshape(B, 2, g, S, D).sum(dim=2)
    dk = (dsb.transpose(-1, -2) @ qf).reshape(B, 2, g, S, D).sum(dim=2)
    dq = dsb @ kf
    for a, b in zip(got, (dq, dk, dv)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.permute(0, 2, 1, 3).to(torch.bfloat16))


CASES = {"mqa 4 over 1": dict(Hq=4, Hk=1, D=32),
         "alibi, scale 1/D": dict(Hq=4, Hk=4, D=80, alibi=True),
         "dropout 0.1": dict(Hq=4, Hk=2, D=32, dropout=0.1)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_float32_backward_matches_jax_grad(case):
    c = CASES[case]
    B, S, D = 2, 40, c["D"]
    q, k, v, do = _inputs(B, S, c["Hq"], c["Hk"], D, seed=5)
    alibi = c.get("alibi", False)
    scale = 1.0 / D if alibi else D ** -0.5
    rate, seed = c.get("dropout", 0.0), 11
    slopes = _slopes(c["Hq"], B) if alibi else None
    jkw = dict(causal=True, scale=scale, impl="ref", dropout_p=rate, dropout_seed=seed,
               alibi_slopes=jax_slopes(c["Hq"]) if alibi else None)

    def loss(q_, k_, v_):
        return jnp.sum(jax_attention(q_, k_, v_, **jkw) * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    qo = torch.zeros(B, dtype=torch.int32)
    kl = torch.full((B,), S, dtype=torch.int32)
    cfg = dict(causal=True, scale=scale, alibi=slopes, dropout_p=rate, dropout_seed=seed)
    o, lse = flash_fwd_plain(q, k, v, qo, kl, window=None, softcap=None, **cfg)
    got = flash_attention_bwd(q, k, v, o, lse, do, window=None, softcap=None, q_offset=qo,
                              kv_lens=kl, **cfg)
    # dq within 2^-14 (it read up to 1.3 x 2^-16): JAX's autograd forms dS
    # from P and dP, the flash formula from di = rowsum(o·dO) with o rounded
    # to float32, and dq's rows cancel; dk and dv within 2^-16 (read 0.06).
    for name, a, b, tol in zip("qkv", got, want, (2.0 ** -14, 2.0 ** -16, 2.0 ** -16)):
        assert float(_row_err(a, torch.from_numpy(np.array(b))).max()) <= tol, f"d{name}"


def _tf32(t):
    """float32 rounded to TF32's 10-bit significand (to nearest)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """``a @ b`` as the kernel's products: 3xTF32 (small·big + big·small +
    big·big) or single-pass TF32."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


#: The float32 K6's tiles (``csrc/flash_attention_bwd_f32.cu::Cfg``): keys a
#: dQ tile and queries a dKV tile, by head dim.
DQ_KEYS = {32: 64, 64: 32, 80: 16, 128: 16, 256: 16}
DKV_QUERIES = {32: 64, 64: 16, 80: 16, 128: 16, 256: 16}


def _tile_sums(parts, order):
    """The running float32 sum of ``parts[..., i, :, :]`` for i in ``order``,
    one rounding add a tile (the kernels' flush)."""
    acc = torch.zeros_like(parts[..., 0, :, :])
    for i in order:
        acc = acc + parts[..., i, :, :]
    return acc


def _emulated_bwd(q, k, v, o, lse, do, scale, slopes, passes, tiled=False, nslices=None):
    """The backward's five products in the kernel's arithmetic (float32
    elsewhere): S recompute, dP, dV, dK, dQ. ``tiled``: the kernels' order
    of sums too: dQ summed a key tile at a time (``DQ_KEYS``), dK and dV a
    query tile at a time (``DKV_QUERIES``) over the q heads of each slice of
    the wrapper's plan (``dkv_slices``, or ``nslices``), head by head, and
    the slices' sums added in slice order; each tile's product (small·big +
    big·small + big·big) added to the running sum by one float32 add."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    g = Hq // Hk
    qf, dof = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = _mm(qf, kf.transpose(-1, -2), passes) * scale
    if slopes is not None:
        s = s + alibi_bias(slopes, torch.zeros(B, dtype=torch.int32), S, S)
    live = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (_mm(dof, vf.transpose(-1, -2), passes) - row_di(o, do)[..., None]) * scale
    if not tiled:
        dv = _mm(p.transpose(-1, -2), dof, passes).reshape(B, -1, g, S, D).sum(dim=2)
        dk = _mm(ds.transpose(-1, -2), qf, passes).reshape(B, -1, g, S, D).sum(dim=2)
        dq = _mm(ds, kf, passes)
        return [t.permute(0, 2, 1, 3) for t in (dq, dk, dv)]
    bn, bq = DQ_KEYS[D], DKV_QUERIES[D]
    # dQ: [B, Hq, tiles, S, D], one part a key tile.
    dq = _tile_sums(_mm(ds.reshape(B, Hq, S, S // bn, bn).transpose(2, 3),
                        kf.reshape(B, Hq, S // bn, bn, D), passes), range(S // bn))
    # dK, dV: [B, Hk, g·tiles, S, D], one part a (q head, query tile).

    def parts(a, b):
        a = a.reshape(B, Hk, g, S // bq, bq, S).transpose(-1, -2)
        b = b.reshape(B, Hk, g, S // bq, bq, D)
        return _mm(a, b, passes).reshape(B, Hk, g * (S // bq), S, D)

    n = nslices or dkv_slices(B, S, Hk, g, D)
    grads = []
    for part in (parts(ds, qf), parts(p, dof)):
        total = None
        for sl in range(n):
            heads = range(sl * g // n, (sl + 1) * g // n)
            acc = _tile_sums(part, [h * (S // bq) + t for h in heads for t in range(S // bq)])
            total = acc if total is None else total + acc
        grads.append(total)
    return [t.permute(0, 2, 1, 3) for t in (dq, *grads)]


@pytest.mark.parametrize("shape", ["btlm: 4 heads of 80, alibi, scale 1/80",
                                   "santacoder: 4 over 1 of 128"])
def test_grad_tolerance_separates_3xtf32_from_single_pass(shape):
    alibi = shape.startswith("btlm")
    B, S, Hq, Hk, D = (1, 512, 4, 4, 80) if alibi else (1, 512, 4, 1, 128)
    q, k, v, do = _inputs(B, S, Hq, Hk, D, seed=13)
    scale = 1.0 / D if alibi else D ** -0.5
    slopes = _slopes(Hq, B) if alibi else None
    qo = torch.zeros(B, dtype=torch.int32)
    kl = torch.full((B,), S, dtype=torch.int32)
    o, lse = flash_fwd_plain(q, k, v, qo, kl, causal=True, window=None, softcap=None,
                             scale=scale, alibi=slopes)
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, window=None,
                                      softcap=None, scale=scale, q_offset=qo, kv_lens=kl,
                                      alibi=slopes)
    three = _emulated_bwd(q, k, v, o, lse, do, scale, slopes, 3)
    one = _emulated_bwd(q, k, v, o, lse, do, scale, slopes, 1)
    for name, a, b in zip("qkv", three, plain):
        assert float(_row_err(a, b).max()) <= 2.0 ** -14, f"3xTF32 d{name}"
    caught = (_row_err(one[0], plain[0]) > GRAD_TOL).double().mean()
    assert caught >= 0.95


@pytest.mark.parametrize("shape", ["santacoder: 8 over 1 of 128, the plan's 8 slices",
                                   "gqa 8: 16 over 2 of 64, 3 slices of 2-3 heads"])
def test_tiled_order_of_sums_keeps_3xtf32_within_float32_noise(shape):
    """The redesigned kernels' order of sums (key and query tiles of their
    Cfg, the GQA group split into slices, summed in slice order) in 3xTF32
    stays within 2^-14 of the plain float32 K6 (the card's tolerance is
    2^-12), and single-pass TF32 in the same order still breaks
    F32_GRAD_TOL in nearly every dq row. At these small shapes the plan
    gives every head its own slice; the kernel takes any count up to the
    group, so the second case splits 8 heads 2, 3, 3 (the plan itself takes
    divisors of the group)."""
    B, S, Hq, Hk, D = (1, 512, 8, 1, 128) if shape.startswith("santa") else (1, 256, 16, 2, 64)
    n = None if shape.startswith("santa") else 3
    assert dkv_slices(B, S, Hk, Hq // Hk, D) == 8
    q, k, v, do = _inputs(B, S, Hq, Hk, D, seed=29)
    scale = D ** -0.5
    qo = torch.zeros(B, dtype=torch.int32)
    kl = torch.full((B,), S, dtype=torch.int32)
    cfg = dict(causal=True, window=None, softcap=None, scale=scale)
    o, lse = flash_fwd_plain(q, k, v, qo, kl, **cfg)
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, q_offset=qo, kv_lens=kl, **cfg)
    three = _emulated_bwd(q, k, v, o, lse, do, scale, None, 3, tiled=True, nslices=n)
    one = _emulated_bwd(q, k, v, o, lse, do, scale, None, 1, tiled=True, nslices=n)
    for name, a, b in zip("qkv", three, plain):
        assert float(_row_err(a, b).max()) <= 2.0 ** -14, f"3xTF32 d{name}"
    caught = (_row_err(one[0], plain[0]) > GRAD_TOL).double().mean()
    assert caught >= 0.95


# (B, Sk, Hk, group, D) of the zoo's float32 training shapes and the split cases
PLAN_SHAPES = {"santacoder B4 S1024 16 over 1 D128": (4, 1024, 1, 16, 128),
               "falcon-7b B8 S512 71 over 1 D64": (8, 512, 1, 71, 64),
               "falcon-7b B2 S2048 71 over 1 D64": (2, 2048, 1, 71, 64),
               "gqa 8 B4 S1024 32 over 4 D128": (4, 1024, 4, 8, 128),
               "gptj-6b B2 S512 MHA D256": (2, 512, 16, 1, 256),
               "btlm-3b B8 S512 MHA D80": (8, 512, 32, 1, 80),
               "debug B2 S256 4 over 2 D32": (2, 256, 2, 2, 32)}


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_dkv_plan_slices_partition_the_group(name):
    B, Sk, Hk, group, D = PLAN_SHAPES[name]
    n = dkv_slices(B, Sk, Hk, group, D)
    assert 1 <= n <= group and group % n == 0
    heads = [list(range(s * group // n, (s + 1) * group // n)) for s in range(n)]
    assert all(len(h) == group // n for h in heads) and sum(heads, []) == list(range(group))
    blocks = -(-Sk // dkv_keys(D)) * (2 if D == 256 else 1) * Hk * B * n
    # The target wherever the group can give it, and no smaller divisor of
    # the group reaches it.
    assert blocks >= min(DKV_TARGET_BLOCKS, blocks // n * group)
    assert all(blocks // n * m < DKV_TARGET_BLOCKS for m in range(1, n) if group % m == 0)
    assert dkv_scratch_shape(B, Sk, Hk, D, n) == (2, n, B, Sk, Hk, D)


def test_dkv_plan_gives_santacoder_and_falcon_a_block_per_sm():
    for B, Sk, Hk, group, D in (PLAN_SHAPES["santacoder B4 S1024 16 over 1 D128"],
                                PLAN_SHAPES["falcon-7b B8 S512 71 over 1 D64"],
                                PLAN_SHAPES["falcon-7b B2 S2048 71 over 1 D64"]):
        n = dkv_slices(B, Sk, Hk, group, D)
        assert n > 1 and -(-Sk // dkv_keys(D)) * (2 if D == 256 else 1) * Hk * B * n >= 132
    assert dkv_slices(*PLAN_SHAPES["gqa 8 B4 S1024 32 over 4 D128"]) == 8
    assert dkv_slices(*PLAN_SHAPES["falcon-7b B8 S512 71 over 1 D64"]) == 71
    assert dkv_slices(*PLAN_SHAPES["gptj-6b B2 S512 MHA D256"]) == 1


def test_wrapper_takes_the_plain_version_on_cpu_tensors_and_dropout_in_the_forward():
    q, k, v, do = _inputs(2, 24, 4, 2, 32, seed=17)
    B, S = 2, 24
    qo = torch.zeros(B, dtype=torch.int32)
    kl = torch.tensor([24, 19], dtype=torch.int32)
    cfg = dict(causal=True, scale=32 ** -0.5, alibi=None, dropout_p=0.1, dropout_seed=3)
    o, lse = flash_fwd_plain(q, k, v, qo, kl, window=None, softcap=None, **cfg)
    got = flash_attention_bwd_f32(q, k, v, o, lse, do, q_offset=qo, kv_lens=kl, **cfg)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=None, softcap=None,
                                     q_offset=qo, kv_lens=kl, **cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # flash_attention takes float32 dropout (the forward's plain version on
    # the CPU) and its autograd backward is the plain K6.
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_lens=kl, dropout_p=0.1, dropout_seed=3)
    assert torch.equal(out, o)
    grads = torch.autograd.grad(out, leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
