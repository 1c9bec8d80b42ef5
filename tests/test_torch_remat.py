"""Per-layer rematerialization (``remat``) on the CPU, port only (JAX's
``jax.checkpoint`` changes no value either, so parity with JAX is the
remat-free tests').

``full`` and ``dots`` against ``none`` through ``Trainer.loss_and_grads``
on ``debug-tiny`` (attention dropout on under the bf16 recipe, the one
that takes it, so its stateless mask is re-drawn in the recompute): the loss, every parameter gradient, the forward amaxes
and the backward amaxes of the sinks bit for bit, each fp8 dot's backward
run once per site and layer (each sink gets one backward), and attention's
forward run once a layer under ``none`` and ``dots`` (its output is kept)
and twice under ``full`` (the layer is recomputed whole).
"""
import numpy as np
import pytest
import torch

from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.models import llama as PL
from llm_fp8_tpu_torch.models.llama import init_params
from llm_fp8_tpu_torch.quant import dot as qdot
from llm_fp8_tpu_torch.training import TrainConfig, Trainer

CFG = get_config("debug-tiny")


@pytest.fixture(autouse=True)
def _semantics_route(monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")


def _batch(seed=0, B=4, S=32):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)}


def _grads(recipes, remat):
    calls = {"bwd": 0, "attention": 0}
    bwd = qdot._Fp8Dot.backward

    def counted_bwd(ctx, *a):
        calls["bwd"] += 1
        return bwd(ctx, *a)

    attention = PL.attention

    def counted_attention(*a, **kw):
        calls["attention"] += 1
        return attention(*a, **kw)

    trainer = Trainer(CFG, TrainConfig(recipes=recipes, remat=remat,
                                       attention_dropout=0.1 if recipes == "bf16" else 0.0),
                      device="cpu")
    state = trainer.init_state(init_params(CFG, dtype=torch.float32, device="cpu", seed=3))
    state.step = 5  # the dropout seed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qdot._Fp8Dot, "backward", staticmethod(counted_bwd))
        mp.setattr(PL, "attention", counted_attention)
        out = trainer.loss_and_grads(state, _batch())
    return out, calls


@pytest.mark.parametrize("recipes", ["default", "bf16"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_remat_free_values_bit_for_bit(recipes, remat):
    (loss, n, amaxes, stats, grads, g_amaxes), calls = _grads(recipes, remat)
    (loss0, n0, amaxes0, stats0, grads0, g_amaxes0), calls0 = _grads(recipes, "none")
    L = CFG.num_layers
    assert torch.equal(loss, loss0) and int(n) == int(n0)
    assert all(torch.equal(a, b) for a, b in zip(stats, stats0))
    assert grads.keys() == grads0.keys()
    for path in grads:
        assert torch.equal(grads[path], grads0[path]), path
    for site in amaxes0:
        for t in ("x", "w", "g"):
            assert torch.equal(getattr(amaxes[site], t), getattr(amaxes0[site], t)), (site, t)
        assert torch.equal(g_amaxes[site], g_amaxes0[site]), site
        assert bool((g_amaxes[site] > 0).all())
    want_bwd = 4 * L if recipes == "default" else 0
    assert calls["bwd"] == calls0["bwd"] == want_bwd
    assert calls0["attention"] == L
    assert calls["attention"] == (2 * L if remat == "full" else L)


def test_remat_modes_and_refusals():
    assert [PL.remat_mode(r) for r in (False, None, "none", True, "full", "dots")] == \
        ["none", "none", "none", "full", "full", "dots"]
    with pytest.raises(ValueError, match="remat policy"):
        PL.remat_mode("offload")
    params = init_params(CFG, dtype=torch.float32, device="cpu")
    cache = PL.init_kv_cache(CFG, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="training options"):
        PL.forward(params, torch.zeros((1, 4), dtype=torch.int32), CFG, cache=cache,
                   remat="full")
