"""``fp8_dot`` in the port (``quant/dot.py``) against the JAX ``fp8_dot``.

Same inputs (x bf16 ``[24, 64]``, float32 master weights ``[64, 48]``, an
output gradient, delayed scales or just-in-time scaling) through the JAX
``custom_vjp`` (eager ``jax.value_and_grad``) and the port's autograd
function: y, dx, dw, the amax sink's gradient (the output gradient's amax)
and ``DotAmaxes``. Recipes DELAYED_HYBRID, DELAYED_E4M3, MXFP8 and the
per-channel int8 training recipe; ``LLM_FP8_NATIVE_DOT`` 0 and 1 (JAX's CPU
runs the fp8 ``dot_general``, the port multiplies the codes in float32);
``LLM_FP8_QUANTIZE`` xla and pallas on the JAX side (XLA's quantize or the
JAX kernel in interpret mode; the port has no such switch and always takes
K9, whose plain version stores the codes of ``quantize``). Every switch is
set explicitly.

Tolerances. Amaxes and the sink gradient: exact (the same max). With the xla
quantize the codes on both sides are the same, and the products differ only
in float32 summation order: y and dx within 2 bf16 ulps of their largest
|value|, dw (float32) within 1e-5 relative to its largest |value|. With the
pallas quantize on a route that quantizes per channel (the narrow routes'
gradients, int8's operands), JAX's jitted kernel multiplies by
``fl(1/fmax)`` where the port divides (``tests/test_torch_quantize.py``), so
a value on a rounding boundary can take the neighbouring code: 1.5 quanta of
the result (``max|ref| / 127`` for int8, ``/ 4`` for the 2-bit-mantissa e5m2
and ``/ 8`` for e4m3), the JAX package's own fused-quantize dot tolerance
(``tests/test_quant.py:569-576``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.quant import recipe as jrecipe
from llm_fp8_tpu.quant.dot import fp8_dot as jax_fp8_dot
from llm_fp8_tpu_torch.convert import tensor_from_numpy
from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
from llm_fp8_tpu_torch.quant import recipe as precipe
from llm_fp8_tpu_torch.quant.dot import _native_mode, fp8_dot

RECIPES = {
    "hybrid": (jrecipe.DELAYED_HYBRID, precipe.DELAYED_HYBRID),
    "e4m3": (jrecipe.DELAYED_E4M3, precipe.DELAYED_E4M3),
    "mxfp8": (jrecipe.MXFP8, precipe.MXFP8),
    "int8_train": (jrecipe.INT8_TRAIN.for_role("mlp"), precipe.INT8_TRAIN.for_role("mlp")),
}
#: One quantum of the result relative to its largest |value| (pallas switch).
QUANTUM = {"hybrid": 1 / 4, "e4m3": 1 / 8, "mxfp8": 1 / 8, "int8_train": 1 / 127}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((24, 64)).astype(np.float32) * 0.7).astype(jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 48)).astype(np.float32) * 0.05)
    g = jnp.asarray(rng.standard_normal((24, 48)).astype(np.float32)).astype(jnp.bfloat16)
    return x, w, g


def _jax_run(x, w, g, xs, ws, recipe):
    def f(x, w, sink):
        y, amaxes = jax_fp8_dot(x, w, xs, ws, sink, recipe)
        return jnp.vdot(y.astype(jnp.float32), g.astype(jnp.float32)), (y, amaxes)

    (_, (y, amaxes)), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        x, w, jnp.zeros(()))
    return [np.asarray(a, np.float32) for a in (y, *grads)], amaxes


def _port_run(x, w, g, xs, ws, recipe):
    xt = tensor_from_numpy(np.asarray(x)).requires_grad_()
    wt = tensor_from_numpy(np.asarray(w)).requires_grad_()
    sink = torch.zeros((), requires_grad=True)
    gt = tensor_from_numpy(np.asarray(g)).float()
    xs = None if xs is None else torch.tensor(float(xs))
    ws = None if ws is None else torch.tensor(float(ws))
    y, amaxes = fp8_dot(xt, wt, xs, ws, sink, recipe)
    dx, dw, dsink = torch.autograd.grad((y.float() * gt).sum(), (xt, wt, sink))
    assert y.dtype == torch.bfloat16 and dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    return [t.detach().float().numpy() for t in (y, dx, dw, dsink)], amaxes


@pytest.mark.parametrize("quantize", ["xla", "pallas"])
@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("name", list(RECIPES))
def test_port_fp8_dot_matches_jax(name, native, quantize, monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", native)
    monkeypatch.setenv("LLM_FP8_QUANTIZE", quantize)
    jrec, prec = RECIPES[name]
    x, w, g = _inputs()
    # Delayed scales a little above the just-in-time ones (tensor recipes use
    # them; the per-channel and MX recipes scale just in time).
    xs = float(jnp.max(jnp.abs(x.astype(jnp.float32)))) / jrec.fmt_fwd.max * 1.3
    ws = float(jnp.max(jnp.abs(w))) / jrec.fmt_fwd.max * 1.1
    if jrec.granularity != "tensor":
        xs = ws = None
    ref, jam = _jax_run(x, w, g, None if xs is None else jnp.float32(xs),
                        None if ws is None else jnp.float32(ws), jrec)
    reset_launch_counts()
    got, pam = _port_run(x, w, g, xs, ws, prec)
    assert all(n == 0 for n in launch_counts().values())
    expect_mode = {"int8_train": "int", "mxfp8": None}.get(name, "fp8" if native == "1" else None)
    assert _native_mode(prec) == expect_mode

    # Amaxes of x and w (forward) and of the output gradient (sink): exact.
    assert float(pam.x) == float(jam.x) and float(pam.w) == float(jam.w)
    assert float(pam.g) == 0.0
    assert got[3] == ref[3] == np.abs(np.asarray(g, np.float32)).max()

    for what, a, b in zip(("y", "dx", "dw"), got[:3], ref[:3]):
        top = np.abs(b).max()
        if quantize == "pallas" and expect_mode is not None:
            tol = 1.5 * QUANTUM[name] * top
        elif what == "dw":
            tol = 1e-5 * top
        else:
            tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=what)


def test_sink_gradient_accumulates_per_layer_slot():
    # forward_fp8_train hands each layer sinks[site][l]; the [L] leaf then
    # collects each layer's backward amax in its own slot.
    rec = precipe.DELAYED_HYBRID
    sinks = torch.zeros(2, requires_grad=True)
    x = torch.randn(8, 32).bfloat16().requires_grad_()
    w = torch.randn(32, 32) * 0.1
    y0, _ = fp8_dot(x, w, None, None, sinks[0], rec)
    y1, _ = fp8_dot(y0, w, None, None, sinks[1], rec)
    gy = torch.randn(8, 32)
    (y1.float() * gy).sum().backward()
    assert float(sinks.grad[1]) == float(gy.bfloat16().float().abs().max())
    assert float(sinks.grad[0]) > 0
