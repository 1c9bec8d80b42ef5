"""Readings behind the tolerances of the port's training parity tests.

    JAX_PLATFORMS=cpu python tests/torch_parity_readings.py

Prints one JSON object with the numbers ``tests/test_torch_training.py``,
``tests/test_torch_quantize.py``, ``tests/test_torch_flash_fp8.py``,
``tests/test_torch_rmsnorm.py`` and ROADMAP's Queue 3 cite, on the same
inputs as the tests (``debug-tiny``, numpy seeds): the share of rows whose
K9 scale equals JAX's; one eager decoder layer, the bf16 and fp8 training
forwards' final hidden states (relative L2), also with XLA's excess
precision turned off (in a second process); the first step's gradients and
loss; three ``Trainer`` steps under ``default`` and ``bf16``; ``evaluate``;
K7's plain version against both JAX routes (largest error, and how far a
bf16 P and a 128-key tile break the tolerance); K8's gradients in bf16;
how far one bf16 ulp on 5% of the embedding entries moves the port's
logits on the xla and the fp8native ``qdot`` routes (``debug-small``, the
reason ``chip_smoke.py`` feeds its fp8native slice the card's projection
inputs). Not a test (pytest does not collect it): it reports, it does not assert.
"""
import json
import os
import subprocess
import sys

os.environ.setdefault("LLM_FP8_NATIVE_DOT", "0")
os.environ.setdefault("LLM_FP8_QUANTIZE", "xla")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from llm_fp8_tpu.kernels.quantize import quantize_fused as jax_quantize_fused  # noqa: E402
from llm_fp8_tpu.models import get_config as jax_get_config  # noqa: E402
from llm_fp8_tpu.models import init_params as jax_init_params  # noqa: E402
from llm_fp8_tpu.models import llama as JL  # noqa: E402
from llm_fp8_tpu.quant import E4M3 as J_E4M3, E5M2 as J_E5M2, INT8 as J_INT8  # noqa: E402
from llm_fp8_tpu.quant import recipe_set_by_name as jax_recipes  # noqa: E402
from llm_fp8_tpu.training import TrainConfig as JTrainConfig, Trainer as JTrainer  # noqa: E402
from llm_fp8_tpu.training import quant_state as jqs  # noqa: E402
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy  # noqa: E402
from llm_fp8_tpu_torch.convert import quant_state_to_numpy, tree_to_numpy  # noqa: E402
from llm_fp8_tpu_torch.kernels.quantize import quantize_fused  # noqa: E402
from llm_fp8_tpu_torch.models import get_config  # noqa: E402
from llm_fp8_tpu_torch.models import llama as PL  # noqa: E402
from llm_fp8_tpu_torch.quant import E4M3, E5M2, INT8, recipe_set_by_name  # noqa: E402
from llm_fp8_tpu_torch.training import TrainConfig, Trainer, quant_state  # noqa: E402
from llm_fp8_tpu_torch.training.trainer import _leaves  # noqa: E402

JCFG, CFG = jax_get_config("debug-tiny"), get_config("debug-tiny")


def _batch(seed=0, B=4, S=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[:, -4:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def k9_scale_agreement():
    rng = np.random.default_rng(0)
    out = {}
    for name, fmt, jfmt in (("e4m3", E4M3, J_E4M3), ("e5m2", E5M2, J_E5M2), ("int8", INT8, J_INT8)):
        for axis in (-1, 0):
            x = (rng.standard_normal((200, 300)) * 3).astype(np.float32)
            a = quantize_fused(torch.from_numpy(x), fmt, axis=axis).scale.numpy()
            b = np.asarray(jax_quantize_fused(jnp.asarray(x), jfmt, axis=axis, interpret=True).scale)
            out[f"{name} axis {axis}"] = float(np.mean(a == b))
    return out


def forward_hidden():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    pp = params_from_numpy(_np(jp))
    ids = _batch()["input_ids"]
    res = {}
    for rec in ("bf16", "default"):
        jr, pr = jax_recipes(rec), recipe_set_by_name(rec)
        h, _ = JL.forward_fp8_train(jp, jnp.asarray(ids), JCFG, jr,
                                    jqs.forward_scales(jqs.init_train_quant_state(JCFG, jr), JCFG),
                                    jqs.make_sinks(JCFG), return_hidden=True)
        with torch.no_grad():
            h2, _ = PL.forward_fp8_train(
                pp, torch.from_numpy(ids), CFG, pr,
                quant_state.forward_scales(quant_state.init_train_quant_state(CFG, pr), CFG),
                quant_state.make_sinks(CFG), return_hidden=True)
        res[rec] = _rel(h2.float().numpy(), np.asarray(h.astype(jnp.float32)))
    return res


def one_layer():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    pp = params_from_numpy(_np(jp))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 32, CFG.hidden_size))
                    .astype(np.float32) * 0.02).astype(jnp.bfloat16)
    jc, js = JL.rope_cos_sin(jnp.arange(32)[None], JL.rope_frequencies(
        JCFG.head_dim, JCFG.rope_theta, JCFG.rope_scaling), JCFG.rope_scaling)
    pc, ps = PL._rope_tables(CFG, torch.arange(32)[None])
    out, _, _ = JL._layer_body(x, jax.tree_util.tree_map(lambda a: a[0], jp["layers"]), jc, js,
                               JCFG, None, jnp.zeros((4,), jnp.int32), None, "ref")
    with torch.no_grad():
        got = PL._layer_body(tensor_from_numpy(np.asarray(x)),
                             PL.unstack_layers(pp["layers"])[0], pc, ps, CFG,
                             lambda q, k, v: PL.attention(q, k, v, causal=True))
    return _rel(got.float().numpy(), np.asarray(out.astype(jnp.float32)))


def first_step():
    res = {}
    b = _batch()
    for rec in ("bf16", "default"):
        jp = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
        init = _np(jp)
        jt = JTrainer(JCFG, JTrainConfig(recipes=rec))
        js = jt.init_state(jp)
        (loss, _), (g, _) = jax.value_and_grad(jt._forward_loss, argnums=(0, 1), has_aux=True)(
            js.params, jqs.make_sinks(JCFG), {k: jnp.asarray(v) for k, v in b.items()},
            js.qstate, js.step)
        pt = Trainer(CFG, TrainConfig(recipes=rec), device="cpu")
        ploss, _, _, _, pg, _ = pt.loss_and_grads(pt.init_state(params_from_numpy(init)), b)
        jg = dict(_leaves(_np(g)))
        res[rec] = {"loss_rel": abs(float(ploss) - float(loss)) / abs(float(loss)),
                    "grad_rel_l2": {k: _rel(v.numpy(), jg[k]) for k, v in pg.items()}}
    return res


def three_steps():
    res = {}
    for rec in ("default", "bf16"):
        kw = dict(recipes=rec, warmup_steps=0, total_steps=10, learning_rate=1e-3)
        jp = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
        init = _np(jp)
        jt = JTrainer(JCFG, JTrainConfig(**kw))
        js = jt.init_state(jp)
        pt = Trainer(CFG, TrainConfig(**kw), device="cpu")
        ps = pt.init_state(params_from_numpy(init))
        steps = []
        for i in range(3):
            b = _batch(i)
            js, jm = jt.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
            ps, pm = pt.train_step(ps, b)
            steps.append({k: (float(pm[k]), float(jm[k])) for k in pm})
        r = {"loss_rel": max(abs(a - b) / abs(b) for a, b in (s["loss"] for s in steps)),
             "grad_norm_rel": max(abs(a - b) / b for a, b in (s["grad_norm"] for s in steps)),
             "activation_mean_abs": max(abs(a - b) for a, b in
                                        (s["activation_mean"] for s in steps)),
             "activation_std_rel": max(abs(a - b) / b for a, b in
                                       (s["activation_std"] for s in steps))}
        jparams, pparams = dict(_leaves(_np(js.params))), dict(_leaves(tree_to_numpy(ps.params)))
        r["params_diff_over_update"] = {
            k: float(np.linalg.norm(pparams[k] - v) / np.linalg.norm(v - p0))
            for (k, p0), v in ((kp, jparams[kp[0]]) for kp in _leaves(init))}
        if js.qstate:
            got = quant_state_to_numpy(ps.qstate)
            hist, oldest, scale = 0.0, 0.0, 0.0
            for site, per in js.qstate.items():
                for t, st in per.items():
                    h, hj = got[site][t]["history"], np.asarray(st.history)
                    nz = hj != 0
                    hist = max(hist, float(np.max(np.abs(h[nz] - hj[nz]) / np.abs(hj[nz]))))
                    oldest = max(oldest, float(np.max(np.abs(h[:, 2] - hj[:, 2]) / np.abs(hj[:, 2]))))
                    sj = np.asarray(st.scale)
                    scale = max(scale, float(np.max(np.abs(got[site][t]["scale"] - sj) / sj)))
            r.update(history_rel=hist, oldest_slot_rel=oldest, scale_rel=scale)
        res[rec] = r
    jp = jax_init_params(JCFG, jax.random.PRNGKey(1), dtype=jnp.float32)
    batches = [_batch(5), _batch(6)]
    ev_j = JTrainer(JCFG, JTrainConfig()).evaluate(
        jp, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    ev_p = Trainer(CFG, TrainConfig(), device="cpu").evaluate(params_from_numpy(_np(jp)), batches)
    res["evaluate_loss_rel"] = abs(ev_p["eval_loss"] - ev_j["eval_loss"]) / ev_j["eval_loss"]
    return res


def flash_fp8():
    import test_torch_flash_fp8 as t

    res = {}
    for name in t.CASES:
        qkv, kw = t._inputs(name)
        r = {}
        for out, jd, td in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
            for native in (True, False):
                want = t._jax(qkv, kw, native, jd)
                got = t._port(qkv, kw, td).float().numpy()
                r[f"max_abs_err {out} {'native' if native else 'dequant'}"] = float(
                    np.abs(got - want).max())
        want = t._jax(qkv, kw, False, jnp.float32)
        bad = t._port(qkv, kw, torch.float32, fn=lambda *a, **k: t.tile_walk(
            *a, **k, p_dtype=torch.bfloat16))
        r["p_bf16_excess_over_tol"] = t._excess(bad, want)
        if "block_k" not in kw:
            r["block_k_128_excess_over_tol"] = t._excess(
                t._port(qkv, {**kw, "block_k": 128}, torch.float32), want)
        res[name] = r
    return res


def rmsnorm_bf16_grads():
    import test_torch_rmsnorm as t

    x, r, w = t._data(1, (2, 64, 128), jnp.bfloat16)

    def loss(x, r, w):
        y, s = t.jax_fused(x, r, w, 1e-5, 64, True)
        return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(s.astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2))(x, r, w)
    xt, rt, wt = (u.requires_grad_() for u in t._torch(x, r, w))
    y, s = t.rmsnorm_residual_fused(xt, rt, wt)
    (y.float().pow(2).sum() + s.float().sin().sum()).backward()
    return {n: {"max_abs_err": float(np.abs(g.float().numpy() - np.asarray(ref, np.float32)).max()),
                "max_abs": float(np.abs(np.asarray(ref, np.float32)).max())}
            for n, g, ref in zip(("dx", "dresidual", "dw"), (xt.grad, rt.grad, wt.grad), want)}


def fp8native_input_ulp_sensitivity():
    """Largest |Δlogit| over a 40-token prompt when one bf16 ulp is added to
    5% of the embedding entries, per ``qdot`` route (LAYERWISE weights)."""
    cfg = get_config("debug-small")
    base = PL.init_params(cfg, device="cpu", seed=7)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(1, cfg.vocab_size, (1, 40), generator=g)
    bump = torch.rand(base["embed"].shape, generator=g) < 0.05
    out, saved = {}, os.environ.get("LLM_FP8_QDOT")
    for route in ("xla", "fp8native"):
        os.environ["LLM_FP8_QDOT"] = route
        p = PL.quantize_params(base, recipe_set_by_name("default"))
        bumped = p["embed"].clone()
        bumped.view(torch.int16)[bump] += 1
        lg, _ = PL.forward(p, prompt, cfg)
        lg2, _ = PL.forward(dict(p, embed=bumped), prompt, cfg)
        out[route] = float((lg.float() - lg2.float()).abs().max())
    if saved is None:
        os.environ.pop("LLM_FP8_QDOT")
    else:
        os.environ["LLM_FP8_QDOT"] = saved
    out["logits_max_abs"] = float(lg.float().abs().max())
    return out


def main():
    if "--hidden-only" in sys.argv:
        print(json.dumps(forward_hidden()))
        return
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                                      + " --xla_allow_excess_precision=false").strip())
    no_excess = subprocess.run([sys.executable, __file__, "--hidden-only"], env=env,
                               capture_output=True, text=True, check=True)
    print(json.dumps({
        "k9_scale_equal_share": k9_scale_agreement(),
        "one_eager_layer_rel": one_layer(),
        "forward_hidden_rel": forward_hidden(),
        "forward_hidden_rel_without_excess_precision": json.loads(
            no_excess.stdout.strip().splitlines()[-1]),
        "first_step": first_step(),
        "three_steps": three_steps(),
        "flash_fp8": flash_fp8(),
        "rmsnorm_bf16_grads": rmsnorm_bf16_grads(),
        "fp8native_input_ulp_sensitivity": fp8native_input_ulp_sensitivity(),
    }, indent=1))


if __name__ == "__main__":
    main()
