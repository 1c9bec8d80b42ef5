"""K1's plain version (the port's ``quant_matmul`` on CPU tensors) and
``qdot`` against the JAX ``quant_matmul`` kernel, which runs in Pallas
interpret mode on the CPU as the JAX package's own tests run it.

Both sides multiply exact bf16 operands in float32; only the order of the
float32 sums differs, so float32 outputs agree to rtol 1e-5 and bf16 outputs
to one bf16 ulp of the largest output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.quant_matmul import quant_matmul as jax_qmm
from llm_fp8_tpu.quant import dot as jdot
from llm_fp8_tpu.quant import formats as jfmt
from llm_fp8_tpu.quant import qtensor as jqt
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import KERNEL_WRAPPERS
from llm_fp8_tpu_torch.kernels import quant_matmul as qmm
from llm_fp8_tpu_torch.kernels.quant_matmul import quant_matmul
from llm_fp8_tpu_torch.quant import dot as tdot
from llm_fp8_tpu_torch.quant import formats as tfmt
from llm_fp8_tpu_torch.quant import qtensor as tqt

K, N = 96, 80


def _case(seed, M, fmt_name, mode):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jf = {"e4m3": jfmt.E4M3, "int8": jfmt.INT8}[fmt_name]
    if mode == "mx":
        jq = jqt.quantize_mx(jnp.asarray(w), jf, block_axis=0, flush_subnormal=True)
        scale = jq.scale
    else:
        jq = jqt.quantize(jnp.asarray(w), jf, axes=None if mode == "tensor" else (0,),
                          flush_subnormal=True)
        scale = jq.scale.reshape(1, -1) if mode == "channel" else jq.scale.reshape(1, 1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, jq, scale


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("fmt_name", ["e4m3", "int8"])
@pytest.mark.parametrize("M", [1, 5, 33])
@pytest.mark.parametrize("mode", ["tensor", "channel", "mx"])
def test_plain_matches_jax_kernel(mode, M, fmt_name):
    xj, jq, scale = _case(M, M, fmt_name, mode)
    ref = np.asarray(jax_qmm(xj, jq.qvalue, scale, mode=mode, out_dtype=jnp.float32))
    got = quant_matmul(tensor_from_numpy(np.asarray(xj)), tensor_from_numpy(np.asarray(jq.qvalue)),
                       tensor_from_numpy(np.asarray(scale)), mode=mode,
                       out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_plain_bf16_output_within_one_ulp():
    xj, jq, scale = _case(7, 17, "e4m3", "channel")
    ref = np.asarray(jax_qmm(xj, jq.qvalue, scale, mode="channel").astype(jnp.float32))
    got = quant_matmul(tensor_from_numpy(np.asarray(xj)), tensor_from_numpy(np.asarray(jq.qvalue)),
                       tensor_from_numpy(np.asarray(scale)), mode="channel")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=_ulp(ref))


@pytest.mark.parametrize("granularity", ["channel", "mx"])
def test_qdot_matches_jax_qdot(granularity):
    """qdot on a QTensor with leading batch dims, both sides on their default
    CPU route (xla: the port's plain torch here, K1 on the card); on flushed
    weights both compute the same products."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    if granularity == "mx":
        jq = jqt.quantize_mx(jnp.asarray(w), jfmt.E4M3, block_axis=0, flush_subnormal=True)
        tq = tqt.quantize_mx(torch.from_numpy(w), tfmt.E4M3, block_axis=0, flush_subnormal=True)
    else:
        jq = jqt.quantize(jnp.asarray(w), jfmt.E4M3, axes=(0,), flush_subnormal=True)
        tq = tqt.quantize(torch.from_numpy(w), tfmt.E4M3, axes=(0,), flush_subnormal=True)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jdot.qdot(xj, jq, out_dtype=jnp.float32))
    got = tdot.qdot(tensor_from_numpy(np.asarray(xj)), tq, out_dtype=torch.float32)
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_plain_version_without_launch():
    before = KERNEL_WRAPPERS["quant_matmul"].launches
    x = torch.ones((2, 64), dtype=torch.bfloat16)
    w = torch.ones((64, 32)).to(torch.float8_e4m3fn)
    y = quant_matmul(x, w, torch.ones((1, 1)), mode="tensor")
    assert float(y[0, 0]) == 64.0
    assert KERNEL_WRAPPERS["quant_matmul"].launches == before == 0


def test_rejects_inputs_the_kernel_does_not_take():
    x = torch.ones((2, 64), dtype=torch.bfloat16)
    w = torch.ones((64, 32)).to(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        quant_matmul(x.float(), w, torch.ones((1, 1)), mode="tensor")
    with pytest.raises(ValueError):
        quant_matmul(x, w, torch.ones((1, 31)), mode="channel")
    with pytest.raises(ValueError):
        quant_matmul(x, w, torch.ones((1, 1)), mode="rows")
    # The kernels read MX scales as stored: bf16 powers of two.
    assert quant_matmul(x, w, torch.ones((2, 32), dtype=torch.bfloat16), mode="mx").shape == (2, 32)
    with pytest.raises(TypeError, match="bf16"):
        quant_matmul(x, w, torch.ones((2, 32)), mode="mx")
    with pytest.raises(ValueError):
        quant_matmul(x[:, :48], w[:48], torch.ones((1, 32), dtype=torch.bfloat16), mode="mx")
    with pytest.raises(TypeError, match="floating point"):
        quant_matmul(x, w, torch.ones((1, 32), dtype=torch.int32), mode="channel")
    with pytest.raises(ValueError):
        quant_matmul(x[None], w, torch.ones((1, 1)), mode="tensor")


#: The (K, N) shapes chip_smoke.py runs through K1: the Llama-3.2-1B
#: projections and lm_head, and its ragged ones.
PLAN_SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 128256),
               (2040, 3000), (2016, 1000), (256, 252)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
def test_split_plan_covers_k_once_in_order(K, N):
    # The decode kernel's split plan, from the shapes alone: splits are the
    # blocks of one cluster (1, 2, 4 or 8) taking consecutive runs of the
    # 32-row k tiles; every run holds at least one tile and together they
    # cover K exactly once, in order.
    k_tiles = -(-K // qmm.split_plan.__globals__["_DROWS"])
    for M in range(1, 64):
        splits, per = qmm.split_plan(M, N, K, 132)
        assert splits in (1, 2, 4, 8)
        runs = [(z * per, min((z + 1) * per, k_tiles)) for z in range(splits)]
        assert runs[0][0] == 0 and runs[-1][1] == k_tiles
        assert all(lo < hi for lo, hi in runs)
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        assert splits == 1 or per >= 8  # eight tiles (two a warp) a run where K has them
