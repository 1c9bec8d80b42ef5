"""K8 in the port (``kernels/rmsnorm.py::rmsnorm_residual_fused``) and
``ops.rmsnorm_residual`` against the JAX package.

On CPU tensors the port's fused function takes its plain version
(``rmsnorm_residual_plain``); the JAX side runs the Pallas kernel in
interpret mode. Inputs are made with numpy from a seed.

The forward-profile probe (``llm_fp8_tpu_torch.scripts.profile_fwd_parts``),
the one entry point that runs K8, prints its keys at debug size on the CPU.

Tolerances: the sum ``s`` is one float32 addition rounded to x's dtype, so it
must be equal bit for bit. ``y`` multiplies by ``rsqrt(mean(s²) + eps)``,
whose sum runs in another order than XLA's, so ``y`` may differ by one
rounding: within 1 bf16 ulp of the larger value (bf16) or 1e-6 relative
(float32). Gradients: float32 within the JAX package's own tolerance for its
fused kernel against its composition (``tests/test_rmsnorm_kernel.py:41-43``,
1e-4); bf16 within 1 bf16 ulp of the gradient's largest |value| (the float32
backward cancels in ``w·dy - x̂·mean(w·dy·x̂)``, so a small entry carries the
rounding of the large ones; read: 2^-10 against an ulp of 2^-7).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.rmsnorm import rmsnorm_residual_fused as jax_fused
from llm_fp8_tpu.ops.rmsnorm import rmsnorm_residual as jax_composed
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
from llm_fp8_tpu_torch.kernels.rmsnorm import rmsnorm_residual_fused, rmsnorm_residual_plain
from llm_fp8_tpu_torch.ops import rmsnorm_residual

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(seed, shape, jdtype):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x, r = (jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdtype)
            for _ in range(2))
    w = jnp.asarray((1.0 + 0.1 * rng.standard_normal((D,))).astype(np.float32)).astype(jdtype)
    return x, r, w


def _torch(*arrays):
    return [tensor_from_numpy(np.asarray(a)) for a in arrays]


def _assert_y_close(got: torch.Tensor, want, dtype_name):
    a = got.float().numpy()
    b = np.asarray(want, np.float32)
    if dtype_name == "bfloat16":
        top = np.maximum(np.abs(a), np.abs(b))
        ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)  # bf16: 8 significant bits
        assert np.all(np.abs(a - b) <= ulp), np.abs(a - b).max()
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(2, 100, 256), (200, 256), (3, 7, 64)])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_fused_matches_the_jax_kernel(dtype_name, shape):
    jd, td = DTYPES[dtype_name]
    x, r, w = _data(len(shape) + shape[-1], shape, jd)
    y_j, s_j = jax_fused(x, r, w, 1e-5, 64, True)
    xt, rt, wt = _torch(x, r, w)
    reset_launch_counts()
    y, s = rmsnorm_residual_fused(xt, rt, wt, 1e-5)
    assert all(n == 0 for n in launch_counts().values())  # CPU: the plain version
    assert y.dtype == s.dtype == td and y.shape == s.shape == xt.shape
    assert torch.equal(s, tensor_from_numpy(np.asarray(s_j)))
    _assert_y_close(y, y_j, dtype_name)
    # block_rows is the TPU kernel's tile: it does not change the result.
    y2, s2 = rmsnorm_residual_fused(xt, rt, wt, 1e-5, block_rows=8)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_composition_matches_jax(dtype_name):
    jd, _ = DTYPES[dtype_name]
    x, r, w = _data(5, (2, 33, 128), jd)
    y_j, s_j = jax_composed(x, r, w, 1e-6)
    y, s = rmsnorm_residual(*_torch(x, r, w), 1e-6)
    assert torch.equal(s, tensor_from_numpy(np.asarray(s_j)))
    _assert_y_close(y, y_j, dtype_name)


def test_fused_and_composition_differ_by_the_sum_rounding_in_bf16():
    # The fused function normalizes the unrounded float32 sum, the
    # composition the sum rounded to bf16: the JAX package's 2e-2 between them.
    x, r, w = _torch(*_data(2, (2, 100, 256), jnp.bfloat16))
    yf, sf = rmsnorm_residual_fused(x, r, w)
    yc, sc = rmsnorm_residual(x, r, w)
    assert torch.equal(sf, sc)
    assert not torch.equal(yf, yc)
    np.testing.assert_allclose(yf.float().numpy(), yc.float().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_gradients_match_jax_grad(dtype_name):
    jd, _ = DTYPES[dtype_name]
    x, r, w = _data(1, (2, 64, 128), jd)

    def loss(x, r, w):
        y, s = jax_fused(x, r, w, 1e-5, 64, True)
        return (jnp.sum(y.astype(jnp.float32) ** 2)
                + jnp.sum(jnp.sin(s.astype(jnp.float32))))

    want = jax.grad(loss, argnums=(0, 1, 2))(x, r, w)
    xt, rt, wt = (t.requires_grad_() for t in _torch(x, r, w))
    y, s = rmsnorm_residual_fused(xt, rt, wt)
    (y.float().pow(2).sum() + s.float().sin().sum()).backward()
    for g, ref in zip((xt.grad, rt.grad, wt.grad), want):
        assert g.dtype == xt.dtype
        ref = np.asarray(ref, np.float32)
        if dtype_name == "float32":
            np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-4)
        else:  # float32 backward rounded to bf16: 1 ulp of the largest |value|
            top_ulp = np.ldexp(1.0, np.frexp(np.abs(ref).max())[1] - 8)
            np.testing.assert_allclose(g.float().numpy(), ref, rtol=0, atol=top_ulp)
    assert torch.equal(xt.grad, rt.grad)  # the sum's gradient goes to both


def test_plain_is_the_fused_function_and_the_wrapper_checks_its_inputs():
    x, r, w = _torch(*_data(3, (4, 96), jnp.float32))
    y, s = rmsnorm_residual_fused(x, r, w, 1e-6)
    yp, sp = rmsnorm_residual_plain(x, r, w, 1e-6)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    with pytest.raises(TypeError):
        rmsnorm_residual_fused(x, r.bfloat16(), w)
    with pytest.raises(ValueError):
        rmsnorm_residual_fused(x, r[:2], w)


def test_forward_profile_probe_prints_its_keys_on_cpu():
    # The one entry point that runs K8 (and K3 on the card), at debug size.
    from llm_fp8_tpu_torch.scripts.profile_fwd_parts import main

    lines = []
    reset_launch_counts()
    out = main(model="debug-tiny", batch=2, seq=16, steps=2, trials=1, profile_model=True,
               device="cpu", echo=lambda line: lines.append(json.loads(line)))
    assert all(n == 0 for n in launch_counts().values())  # CPU: the plain versions
    assert [next(iter(d)) for d in lines[:-1]] == ["gemms_ms", "flash_ms", "norms_ms", "model_ms"]
    assert lines[-1] == out
    assert {"gemms_ms", "flash_ms", "norms_ms", "model_ms", "gemm_ideal_ms", "device"} <= set(out)
    assert all(out[k] > 0 for k in ("gemms_ms", "flash_ms", "norms_ms", "model_ms"))
    assert out["device"] == "cpu" and out["gemm_ideal_ms"] is None  # no card, no peak


def test_forward_profile_probe_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from llm_fp8_tpu_torch.scripts.profile_fwd_parts import main
    from llm_fp8_tpu_torch.utils.backend import card_peaks

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(model="debug-tiny")
    assert card_peaks("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12)
    assert card_peaks("NVIDIA H100 PCIe")[1] == 756e12 and card_peaks("cpu") is None
