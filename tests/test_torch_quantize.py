"""K9 in the port (``kernels/quantize.py``) against the JAX ``quantize_fused``.

The plain version (what ``quantize_fused`` runs on CPU tensors) against the
JAX kernel in Pallas interpret mode: rows and columns; e4m3, e5m2 and int8;
bf16 and float32 input; unaligned shapes (13x200, 200x13); ``margin=1``.

Pinned reading: the JAX kernel is jitted, and XLA rewrites its division by
the constant ``fmt.max`` into a multiplication by the reciprocal, so its
scale is ``fl(max(amax, tiny) · fl(1/fmax))``. The port divides (as the
port's ``quant.quantize`` does, on the CPU and on the card, and as the CUDA
kernel does with ``__fdiv_rn``): ``fl(max(amax, tiny) / fmax)``. The two
scales are each pinned to their formula exactly and differ by at most one
float32 ulp (in about half of the rows for e4m3 and e5m2, 2.5-5.7% for int8:
``tests/torch_parity_readings.py``). Codes are bit-identical wherever the scales are; where a scale is one
ulp apart, a code may sit one step away (a value on a rounding boundary).
Against the port's own ``quant.quantize`` the plain version is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.quantize import quantize_fused as jax_quantize_fused
from llm_fp8_tpu.quant import E4M3 as J_E4M3, E5M2 as J_E5M2, INT8 as J_INT8
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels.quantize import quantize_fused
from llm_fp8_tpu_torch.quant import E4M3, E5M2, INT8, quantize

FMTS = {"e4m3": (E4M3, J_E4M3), "e5m2": (E5M2, J_E5M2), "int8": (INT8, J_INT8)}


def _codes_as_int(q: torch.Tensor) -> np.ndarray:
    """Codes as signed integers ordered like their values (fp8 sign-magnitude
    bytes mapped onto a monotone integer line), so one step apart is |Δ| 1."""
    b = q.view(torch.uint8).numpy().astype(np.int32)
    if q.dtype == torch.int8:
        return q.numpy().astype(np.int32)
    return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)


def _run(shape, fmt_name, axis, dtype, seed, margin=0):
    fmt, jfmt = FMTS[fmt_name]
    x = (np.random.default_rng(seed).standard_normal(shape) * 3.0).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = jax_quantize_fused(xj, jfmt, axis=axis, margin=margin, interpret=True)
    xt = tensor_from_numpy(np.asarray(xj))
    got = quantize_fused(xt, fmt, axis=axis, margin=margin)
    return x, xj, xt, ref, got, fmt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("fmt_name", list(FMTS))
def test_plain_k9_matches_jax_quantize_fused(fmt_name, axis, dtype):
    for shape, seed in (((13, 200), 1), ((200, 13), 2)):
        x, xj, xt, ref, got, fmt = _run(shape, fmt_name, axis, dtype, seed)
        want_shape = (shape[0], 1) if axis % 2 == 1 else (1, shape[1])
        assert tuple(got.scale.shape) == tuple(ref.scale.shape) == want_shape
        assert got.qvalue.dtype == fmt.dtype
        # Each scale is its own formula exactly (float32 arithmetic in numpy).
        amax = np.abs(np.asarray(xj, np.float32)).max(axis=axis % 2, keepdims=True)
        amax = np.maximum(amax, np.float32(1e-12))
        fmax = np.float32(fmt.max)
        np.testing.assert_array_equal(got.scale.numpy(), amax / fmax)
        np.testing.assert_array_equal(np.asarray(ref.scale), amax * (np.float32(1) / fmax))
        s_got, s_ref = got.scale.numpy(), np.asarray(ref.scale)
        assert np.all(np.abs(s_got.view(np.int32) - s_ref.view(np.int32)) <= 1)
        # Codes: identical where the scales are, at most one step elsewhere.
        same = np.broadcast_to(s_got == s_ref, shape)
        c_got = _codes_as_int(got.qvalue)
        c_ref = _codes_as_int(tensor_from_numpy(np.asarray(ref.qvalue)))
        np.testing.assert_array_equal(c_got[same], c_ref[same])
        assert np.abs(c_got - c_ref).max() <= 1
        # The plain version is the port's quant.quantize, bit for bit.
        want = quantize(xt, fmt, axes=(axis % 2,))
        assert torch.equal(got.qvalue.view(torch.uint8), want.qvalue.view(torch.uint8))
        assert torch.equal(got.scale, want.scale)


@pytest.mark.parametrize("fmt_name", ["int8", "e4m3"])
def test_plain_k9_margin(fmt_name):
    x, xj, xt, ref, got, fmt = _run((32, 128), fmt_name, -1, "bf16", 3, margin=1)
    s_got, s_ref = got.scale.numpy(), np.asarray(ref.scale)
    assert np.all(np.abs(s_got.view(np.int32) - s_ref.view(np.int32)) <= 1)
    same = np.broadcast_to(s_got == s_ref, x.shape)
    c_got = _codes_as_int(got.qvalue)
    c_ref = _codes_as_int(tensor_from_numpy(np.asarray(ref.qvalue)))
    np.testing.assert_array_equal(c_got[same], c_ref[same])
    want = quantize(xt, fmt, axes=(1,), margin=1)
    assert torch.equal(got.qvalue.view(torch.uint8), want.qvalue.view(torch.uint8))
    assert torch.equal(got.scale, want.scale)
    # margin 1 doubles the scale: the largest code is about half the range.
    assert float(got.qvalue.float().abs().max()) <= fmt.max / 2 + 1


def test_wrapper_checks_and_counts_no_launch_on_the_cpu():
    quantize_fused.launches = 0
    q = quantize_fused(torch.randn(4, 8), E4M3)
    assert q.scale.shape == (4, 1) and quantize_fused.launches == 0
    with pytest.raises(ValueError, match="2-D"):
        quantize_fused(torch.randn(2, 3, 4), E4M3)
    with pytest.raises(TypeError, match="float32 or bf16"):
        quantize_fused(torch.randn(4, 8).half(), E4M3)


#: The shapes chip_smoke.py runs K9 at, and the route each takes: the
#: training step's float32 gradients [4096, N] (rows and columns), the
#: serving route's bf16 rows at a prefill bucket and at decode, one case of
#: each remaining route, and a ragged shape (the scalar edge).
ROUTE_CASES = [
    (4096, 3072, "f32", 1, ("rows_regs", 4, 8)),
    (4096, 2048, "f32", 1, ("rows_regs", 2, 8)),
    (4096, 16384, "f32", 1, ("rows_regs", 16, 8)),
    (4096, 16384, "bf16", 1, ("rows_regs", 16, 4)),
    (4096, 3072, "f32", 0, ("cols_cluster", 0, 0)),
    (4096, 16384, "f32", 0, ("cols_cluster", 0, 0)),
    (4096, 2048, "bf16", 0, ("cols_cluster", 0, 0)),
    (8192, 2048, "bf16", 1, ("rows_regs", 2, 4)),
    (8192, 8192, "bf16", 1, ("rows_regs", 8, 4)),
    (8, 2048, "bf16", 1, ("rows_regs", 2, 4)),
    (8, 8192, "bf16", 1, ("rows_regs", 8, 4)),
    (64, 32768, "f32", 1, ("rows_smem", 0, 0)),
    (16, 65536, "f32", 1, ("rows_stream", 0, 0)),
    (16384, 512, "f32", 0, ("cols_stream", 0, 0)),
    (300, 1001, "f32", 1, ("rows_regs", 1, 8)),
    (300, 1001, "bf16", 0, ("cols_cluster", 0, 0)),
]


@pytest.mark.parametrize("M,N,dtype,axis,want", ROUTE_CASES,
                         ids=[f"{m}x{n}-{d}-axis{a}" for m, n, d, a, _ in ROUTE_CASES])
def test_route_of_each_chip_shape(M, N, dtype, axis, want):
    """K9's route follows from (M, N, dtype, axis) alone, and each route
    holds its operand where the source note says: rows_regs' warps x 32
    lanes x vecs 16-byte vectors cover the row with the fewest warps (at
    most 32 elements a lane), rows_smem's row and cols_cluster's slab fit
    192 KiB, and the streaming routes take only what those cannot."""
    from llm_fp8_tpu_torch.kernels.quantize import ROUTES, route

    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    got = route(M, N, dt, axis)
    assert got == want and got == route(M, N, dt, axis - 2) and got[0] in ROUTES
    name, warps, vecs = got
    esize = 4 if dtype == "f32" else 2
    nv, vecs_max = -(-N * esize // 16), 32 * esize // 16
    if name == "rows_regs":
        assert 32 * warps * vecs >= nv and vecs <= vecs_max and warps <= 16
        assert warps == 1 or 32 * (warps // 2) * vecs_max < nv
        assert vecs == 1 or 32 * warps * (vecs // 2) < nv
    elif name.startswith("rows"):
        assert nv > 16 * 32 * vecs_max and (nv * 16 <= 192 * 1024) == (name == "rows_smem")
    else:
        slab = -(-M // 8) * 32 * esize
        assert (slab <= 192 * 1024) == (name == "cols_cluster")
