"""Port numerics against the JAX package: quantized codes and scales bit for
bit, MX blocks, dequantize, the FTZ dequant helpers and the recipe sets.

Inputs are made from a seed with numpy and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels import _common as jcommon
from llm_fp8_tpu.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from llm_fp8_tpu.quant import formats as jfmt
from llm_fp8_tpu.quant import qtensor as jqt
from llm_fp8_tpu.quant import recipe as jrecipe
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import _common as tcommon
from llm_fp8_tpu_torch.quant import formats as tfmt
from llm_fp8_tpu_torch.quant import qtensor as tqt
from llm_fp8_tpu_torch.quant import recipe as trecipe


def _bits(x) -> np.ndarray:
    """Raw bytes of a JAX array or a torch tensor, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _weights(seed=0, shape=(64, 48)):
    """Weight-like values with outliers and entries below e4m3's normal range."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 0.02
    x.flat[::7] *= 1e-4  # land on subnormal codes at per-channel scales
    x.flat[3] = 0.5  # an outlier that sets a channel's amax
    return x


FMTS = [("e4m3", jfmt.E4M3, tfmt.E4M3), ("e5m2", jfmt.E5M2, tfmt.E5M2),
        ("int8", jfmt.INT8, tfmt.INT8)]


@pytest.mark.parametrize("flush", [False, True])
@pytest.mark.parametrize("axes", [None, (0,)], ids=["tensor", "channel"])
@pytest.mark.parametrize("name,jf,tf", FMTS, ids=[f[0] for f in FMTS])
def test_quantize_codes_and_scales_bit_exact(name, jf, tf, axes, flush):
    x = _weights()
    jq = jqt.quantize(jnp.asarray(x), jf, axes=axes, flush_subnormal=flush)
    tq = tqt.quantize(torch.from_numpy(x), tf, axes=axes, flush_subnormal=flush)
    np.testing.assert_array_equal(_bits(tq.qvalue), _bits(jq.qvalue))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    # Dequantize is exact arithmetic on equal codes: equal values.
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))


def test_quantize_given_scale_saturates_like_jax():
    x = _weights(1) * 100.0
    scale = np.float32(0.01)
    jq = jqt.quantize(jnp.asarray(x), jfmt.E4M3, scale=jnp.asarray(scale))
    tq = tqt.quantize(torch.from_numpy(x), tfmt.E4M3, scale=torch.tensor(scale))
    np.testing.assert_array_equal(_bits(tq.qvalue), _bits(jq.qvalue))
    assert np.isfinite(tq.qvalue.float().numpy()).all()


@pytest.mark.parametrize("group", [None, 16])
def test_int4_split_half_pack_round_trips(group):
    x = _weights(2, (64, 32))
    jq = jqt.quantize(jnp.asarray(x), jfmt.INT4, axes=(0,), group_size=group)
    tq = tqt.quantize(torch.from_numpy(x), tfmt.INT4, axes=(0,), group_size=group)
    np.testing.assert_array_equal(_bits(tq.qvalue), _bits(jq.qvalue))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert (tq.pack_axis, tq.block_axis, tq.block_size) == (jq.pack_axis, jq.block_axis,
                                                           jq.block_size)
    np.testing.assert_array_equal(tq.unpack().numpy(), np.asarray(jq.unpack()))
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))


@pytest.mark.parametrize("flush", [False, True])
def test_quantize_mx_bit_exact(flush):
    x = _weights(3, (96, 40))
    jq = jqt.quantize_mx(jnp.asarray(x), jfmt.E4M3, block_axis=0, flush_subnormal=flush)
    tq = tqt.quantize_mx(torch.from_numpy(x), tfmt.E4M3, block_axis=0, flush_subnormal=flush)
    np.testing.assert_array_equal(_bits(tq.qvalue), _bits(jq.qvalue))
    np.testing.assert_array_equal(_bits(tq.scale), _bits(jq.scale))  # bf16 powers of two
    assert (tq.block_size, tq.block_axis) == (jq.block_size, jq.block_axis)
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))


def test_e4m3_ftz_helper_matches_jax_kernel_route_on_all_codes():
    """Every e4m3 code except NaN (0x7F/0xFF) through the JAX kernel's FTZ
    dequant — ``quant_matmul(eye, codes, ones, mode="channel")`` maps each
    code to its value — against the port's helper. Exact."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    n = len(codes)
    w = jnp.asarray(codes.reshape(n, 1)).view(jnp.float8_e4m3fn)
    eye = jnp.eye(n, dtype=jnp.bfloat16)
    ref = np.asarray(jax_quant_matmul(eye, w, jnp.ones((1, 1), jnp.float32), mode="channel",
                                      out_dtype=jnp.float32))[:, 0]
    got = tcommon.e4m3_to_bf16_ftz(torch.from_numpy(codes).view(torch.float8_e4m3fn))
    np.testing.assert_array_equal(got.float().numpy(), ref)
    # The subnormal codes flush (the TPU route); 0x08 is the smallest normal.
    assert ref[codes.tolist().index(0x01)] == 0 and ref[codes.tolist().index(0x08)] == 2.0 ** -6


def test_e5m2_ftz_helper_flushes_subnormals_and_keeps_normals():
    """e5m2 on the FTZ route: exponent-0 codes → ±0, every other finite code
    equals JAX's exact conversion (exponent-31 codes are inf/NaN there and
    finite on the FTZ route, so they are left out)."""
    codes = np.array([c for c in range(256) if (c >> 2) & 0x1F != 0x1F], np.uint8)
    exact = np.asarray(jnp.asarray(codes).view(jnp.float8_e5m2).astype(jnp.float32))
    want = np.where(((codes >> 2) & 0x1F) == 0, 0.0, exact).astype(np.float32)
    got = tcommon.fp8_to_bf16_ftz(torch.from_numpy(codes).view(torch.float8_e5m2))
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape,axis,multiple", [((5, 7), 0, 4), ((5, 7), 1, 8),
                                                  ((8, 3), 0, 8)])
def test_pad_to_multiple_matches_jax(shape, axis, multiple):
    x = _weights(5, shape)
    ref = np.asarray(jcommon.pad_to_multiple(jnp.asarray(x), axis, multiple))
    got = tcommon.pad_to_multiple(torch.from_numpy(x), axis, multiple)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_tensor_from_numpy_reads_bf16_and_fp8_by_name():
    x = _weights(4, (8, 8))
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float8_e4m3fn, torch.float8_e4m3fn),
                     (jnp.float8_e5m2, torch.float8_e5m2)):
        a = np.asarray(jnp.asarray(x).astype(jdt))
        t = tensor_from_numpy(a)
        assert t.dtype == tdt
        np.testing.assert_array_equal(_bits(t), _bits(a))


def test_recipe_sets_match():
    for name in ("layerwise", "hybrid", "mxfp8", "int8", "int4", "int8_train", "bf16",
                 "default"):
        js, ts = jrecipe.recipe_set_by_name(name), trecipe.recipe_set_by_name(name)
        assert js.name == ts.name and js.enabled == ts.enabled
        for role in ("attn_qkv", "attn_out", "mlp", "kv_cache", "lm_head", "embed"):
            jr, tr = js.for_role(role), ts.for_role(role)
            assert (jr is None) == (tr is None), (name, role)
            if jr is not None:
                assert (jr.granularity, jr.fmt_fwd.name, jr.fmt_bwd.name, jr.margin,
                        jr.group_size) == (tr.granularity, tr.fmt_fwd.name,
                                           tr.fmt_bwd.name, tr.margin, tr.group_size)
    with pytest.raises(ValueError):
        trecipe.recipe_set_by_name("nope")
