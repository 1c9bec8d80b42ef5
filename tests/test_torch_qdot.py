"""The port's ``qdot`` routes against the JAX ``qdot`` on the CPU.

Weights are quantized by the JAX package from a numpy seed and carried
across as numpy (``convert.params_from_numpy``), so both sides hold the same
codes and scales. JAX's ``"fused"`` route runs its Pallas kernel in
interpret mode, as the JAX package's own tests run it.

Tolerances: every route multiplies exact operands (bf16 or float32
activations, or e4m3 codes, against exactly converted weights) with float32
sums; only the order of those sums differs, so float32 outputs are held to
rtol 1e-5 with an atol of 1e-6 of the largest output. The fp8native route
also quantizes x per row to e4m3 on both sides, code for code (K9's plain
version stores ``quantize``'s codes bit for bit), so it is held to the same.

Also here: the route each side picks under ``LLM_FP8_NATIVE_DOT`` and
``LLM_FP8_QDOT`` (counted through K9's and K1's wrappers), a float32 forward
over LAYERWISE weights, ``serve --precision int4``, and the paged engine's
int8 pool (refused by the CLI at its unit scale; served with an explicit
``kv_scale``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant import dot as jdot
from llm_fp8_tpu.quant import formats as jfmt
from llm_fp8_tpu.quant import qtensor as jqt
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu.serving import paged_engine as jpe
from llm_fp8_tpu.serving.engine import SamplingParams as JSamplingParams
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.kernels import quant_matmul as k1_mod
from llm_fp8_tpu_torch.kernels import quantize as k9_mod
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.models import llama as tllama
from llm_fp8_tpu_torch.quant import LAYERWISE as T_LAYERWISE
from llm_fp8_tpu_torch.quant import dot as tdot
from llm_fp8_tpu_torch.serving import paged_engine as tpe
from llm_fp8_tpu_torch.serving.engine import SamplingParams

N = 80
JFMT = {"e4m3": jfmt.E4M3, "e5m2": jfmt.E5M2, "int8": jfmt.INT8, "int4": jfmt.INT4}


def numpy_tree(tree):
    """JAX params → numpy arrays, QTensors as dicts of their fields."""
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _jq_to_port(jq):
    return params_from_numpy(numpy_tree(jq))


def _weight(fmt, mode, K, seed):
    w = jnp.asarray((np.random.default_rng(seed).standard_normal((K, N)) * 0.02)
                    .astype(np.float32))
    if mode == "mx":
        return jqt.quantize_mx(w, JFMT[fmt], block_axis=0, flush_subnormal=True)
    if mode == "group":
        return jqt.quantize(w, JFMT[fmt], axes=(0,), group_size=32)
    return jqt.quantize(w, JFMT[fmt], axes=None if mode == "tensor" else (0,),
                        flush_subnormal=True)


def _x(K, dtype, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 3, K)).astype(np.float32))
    return x.astype(dtype)


CASES = ([(impl, fmt, mode, "bf16", 96) for impl in ("xla", "fused", "fp8native")
          for fmt in ("e4m3", "e5m2", "int8") for mode in ("tensor", "channel", "mx")]
         + [("xla", fmt, mode, "f32", 96) for fmt in ("e4m3", "e5m2", "int8")
            for mode in ("tensor", "channel", "mx")]
         + [("xla", "int4", "channel", x, 96) for x in ("bf16", "f32")]
         + [("xla", "int4", "group", "bf16", K) for K in (128, 96)]  # 96: groups straddle
         + [("xla", "int8", "group", "bf16", 96), ("fp8native", "int8", "channel", "bf16", 96)])


@pytest.mark.parametrize("impl,fmt,mode,xdt,K", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_qdot_route_matches_jax(impl, fmt, mode, xdt, K):
    jq = _weight(fmt, mode, K, seed=K + len(fmt))
    xj = _x(K, jnp.bfloat16 if xdt == "bf16" else jnp.float32, seed=3)
    ref = np.asarray(jdot.qdot(xj, jq, impl=impl, out_dtype=jnp.float32))
    got = tdot.qdot(tensor_from_numpy(np.asarray(xj)), _jq_to_port(jq), impl=impl,
                    out_dtype=torch.float32)
    assert got.shape == (2, 3, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()))


def _jax_route(xj, jq):
    """The route JAX's qdot took, read from its jaxpr."""
    jx = str(jax.make_jaxpr(lambda x: jdot.qdot(x, jq))(xj))
    if "pallas_call" in jx:
        return "fused"
    return "fp8native" if "new_dtype=float8_e4m3fn" in jx else "xla"


@pytest.mark.parametrize("native,qdot_env,fmt,want", [
    ("1", None, "e4m3", "fp8native"), ("0", None, "e4m3", "xla"),
    ("1", "xla", "e4m3", "xla"), ("0", "fp8native", "e4m3", "fp8native"),
    ("0", "fused", "e4m3", "fused"), ("1", None, "int8", "xla")])
def test_route_selection_follows_env(native, qdot_env, fmt, want, monkeypatch):
    """Mirrors ``tests/test_quant.py::test_auto_selection_follows_backend``:
    both sides pick the same route; the port's is counted through K9's
    wrapper (fp8native quantizes x there) and K1's (fused)."""
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", native)
    if qdot_env is None:
        monkeypatch.delenv("LLM_FP8_QDOT", raising=False)
    else:
        monkeypatch.setenv("LLM_FP8_QDOT", qdot_env)
    calls = {"k9": 0, "k1": 0}

    def counted(fn, key):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(k9_mod, "quantize_fused", counted(k9_mod.quantize_fused, "k9"))
    monkeypatch.setattr(k1_mod, "quant_matmul", counted(k1_mod.quant_matmul, "k1"))
    monkeypatch.setattr(tdot, "_FP8NATIVE_WARNED", False)
    jq = _weight(fmt, "channel", 64, seed=38)
    xj = _x(64, jnp.bfloat16, seed=37)
    assert _jax_route(xj, jq) == want
    tq = _jq_to_port(jq)
    assert tdot.qdot_route(tq) == want
    if want == "fp8native" and qdot_env is None:
        with pytest.warns(UserWarning, match="auto-selected the fp8-operand route"):
            tdot.qdot(tensor_from_numpy(np.asarray(xj)), tq)
    else:
        tdot.qdot(tensor_from_numpy(np.asarray(xj)), tq)
    assert calls == {"k9": int(want == "fp8native"), "k1": int(want == "fused")}


def test_serving_layout_follows_the_route(monkeypatch):
    """``quantize_params`` lays fp8native weights out as the ``.t()`` view of
    contiguous ``[N, K]`` codes (what ``torch._scaled_mm`` takes) and every
    other weight row-major (what K1 takes); the codes are the same."""
    tc = tconfig.get_config("debug-tiny")
    params = tllama.init_params(tc, dtype=torch.bfloat16, device="cpu", seed=0)
    layouts = {}
    for native in ("1", "0"):
        monkeypatch.setenv("LLM_FP8_NATIVE_DOT", native)
        monkeypatch.delenv("LLM_FP8_QDOT", raising=False)
        layouts[native] = tllama.quantize_params(params, T_LAYERWISE)
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        kq, rq = layouts["1"]["layers"][name].qvalue, layouts["0"]["layers"][name].qvalue
        assert kq.stride(-2) == 1 and kq.transpose(-1, -2).is_contiguous()
        assert rq.is_contiguous()
        assert torch.equal(kq.view(torch.uint8), rq.view(torch.uint8))


def test_float32_forward_over_layerwise_weights_matches_jax():
    """A float32 forward over LAYERWISE fp8 weights (the xla route's float32
    arithmetic on both sides): rtol 1e-4, as the float32 forward of
    ``test_torch_llama.py``."""
    import dataclasses

    jc = dataclasses.replace(jconfig.get_config("debug-tiny"), num_layers=2)
    tc = dataclasses.replace(tconfig.get_config("debug-tiny"), num_layers=2)
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32), J_LAYERWISE)
    tp = params_from_numpy(numpy_tree(jp))
    toks = np.random.default_rng(2).integers(1, jc.vocab_size, (2, 10)).astype(np.int32)
    lens = np.asarray([10, 6], np.int32)
    jl, _ = jllama.forward(jp, jnp.asarray(toks), jc, kv_lens=jnp.asarray(lens),
                           compute_dtype=jnp.float32)
    tl, _ = tllama.forward(tp, torch.from_numpy(toks), tc, kv_lens=torch.from_numpy(lens),
                           compute_dtype=torch.float32)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)


def test_serve_cli_int4_runs_on_cpu(capsys):
    from llm_fp8_tpu_torch.cli.serve import main

    main(["--model_name", "debug-tiny", "--random_init", "--precision", "int4",
          "--kv_dtype", "bf16", "--device", "cpu", "--num_requests", "2", "--prompt_len", "8",
          "--max_new_tokens", "3", "--max_seq_len", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["precision"] == "int4" and out["requests"] == 2
    assert out["generated_tokens"] == 6


def test_serve_cli_refuses_paged_int8_with_its_reason():
    from llm_fp8_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit, match=r"kv_scale = 1.*round\(K\)"):
        main(["--model_name", "debug-tiny", "--random_init", "--device", "cpu", "--paged",
              "--kv_dtype", "int8"])


def test_paged_engine_serves_int8_pages_with_explicit_scale():
    """The engine itself keeps int8 pools with a given ``kv_scale`` (as
    ``tests/test_paged_engine.py`` holds the JAX one): the same greedy
    tokens as the JAX engine, and the pool's codes are not mostly zero."""
    jc, tc = jconfig.get_config("debug-tiny"), tconfig.get_config("debug-tiny")
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(4), dtype=jnp.bfloat16), J_LAYERWISE)
    tp = params_from_numpy(numpy_tree(jp))
    kw = dict(max_slots=2, num_pages=12, page_size=16, max_pages_per_seq=4,
              prefill_buckets=(16, 32), decode_burst=1, kv_scale=1 / 16)
    jeng = jpe.PagedEngine(jp, jc, jpe.PagedEngineConfig(kv_dtype=jnp.int8, **kw))
    teng = tpe.PagedEngine(tp, tc, tpe.PagedEngineConfig(kv_dtype=torch.int8, **kw),
                           device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32) for n in (5, 12, 20)]
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=5)) for p in prompts]
    treqs = [teng.add_request(p, SamplingParams(max_new_tokens=5)) for p in prompts]
    jeng.run()
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.k_pages.dtype == torch.int8
    assert float((teng.k_pages != 0).float().mean()) > 0.05
