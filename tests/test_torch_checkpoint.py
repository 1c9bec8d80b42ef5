"""Train-state checkpoints, the HF export and the comparison study's CLI.

* ``CheckpointManager``: JAX's layout (``ckpt_<step>``, ``meta_<step>.json``,
  ``ckpt_best``, the newest ``keep`` kept), restore by tag, and a run saved
  at step 2 and resumed in a fresh ``Trainer`` that equals the
  uninterrupted run bit for bit (parameters, AdamW and delayed-scaling
  state, the steps' metrics).
* ``export_hf`` against JAX ``export_hf``: every tensor bit for bit (both
  files read by the port's own safetensors reader) and ``config.json``
  equal, for float32 and LAYERWISE-quantized parameters and Baichuan's
  fused ``W_pack``; and read back by ``load_hf_checkpoint``.
* ``cli.compare`` on ``debug-tiny`` writes the keys JAX's writes, merges a
  second run with ``--resume`` and refuses the packed corpus.
"""
import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu.training.checkpoint import export_hf as jax_export_hf
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.models.hf_loader import load_hf_checkpoint, read_safetensors
from llm_fp8_tpu_torch.models.llama import init_params
from llm_fp8_tpu_torch.quant import QTensor
from llm_fp8_tpu_torch.training import CheckpointManager, TrainConfig, Trainer, export_hf
from llm_fp8_tpu_torch.training.trainer import _leaves

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

CFG = get_config("debug-tiny")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _semantics_route(monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, CFG.vocab_size, (4, 32)).astype(np.int32)}


def _trainer(**kw):
    return Trainer(CFG, TrainConfig(**{**dict(recipes="default", warmup_steps=0,
                                              total_steps=10, learning_rate=1e-3), **kw}),
                   device="cpu")


def _fresh(trainer):
    return trainer.init_state(init_params(CFG, dtype=torch.float32, device="cpu", seed=2))


def _flat(state):
    """Every tensor of a train state by path, and its ints."""
    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x.detach()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        else:
            out[path] = x

    walk(state, "state")
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_manager_layout_best_cleanup_and_restore(tmp_path):
    trainer = _trainer()
    state = _fresh(trainer)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    saved = {}
    for step, eval_loss in ((1, 3.0), (2, 2.0), (3, 2.5)):
        state, _ = trainer.train_step(state, _batch(step))
        mgr.save(state, state.step, eval_loss=eval_loss)
        saved[step] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                       for k, v in _flat(state).items()}
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_2", "ckpt_3", "ckpt_best", "meta_2.json", "meta_3.json"]
    assert json.loads((tmp_path / "meta_3.json").read_text()) == {"step": 3, "eval_loss": 2.5}
    for tag, step in (("latest", 3), (3, 3), ("best", 2), (2, 2)):
        got = _flat(mgr.restore(_fresh(_trainer()), tag))
        for k, v in saved[step].items():
            assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v), k
    with pytest.raises(FileNotFoundError):
        mgr.restore(_fresh(_trainer()), 1)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


@pytest.mark.parametrize("kw", [dict(), dict(recipes="bf16", grad_accum=2,
                                             adam_mu_dtype="bfloat16", attention_dropout=0.1)])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, kw):
    trainer = _trainer(**kw)
    state = _fresh(trainer)
    whole = []
    for i in range(4):
        state, m = trainer.train_step(state, _batch(i))
        whole.append({k: v.clone() for k, v in m.items()})
    part = _trainer(**kw)
    pstate = _fresh(part)
    for i in range(2):
        pstate, _ = part.train_step(pstate, _batch(i))
    CheckpointManager(str(tmp_path)).save(pstate, pstate.step)
    resumed = _trainer(**kw)
    rstate = CheckpointManager(str(tmp_path)).restore(_fresh(resumed))
    assert rstate.step == 2
    assert all(t.requires_grad for _, t in _leaves(rstate.params))
    for i in (2, 3):
        rstate, m = resumed.train_step(rstate, _batch(i))
        for k, v in m.items():
            assert torch.equal(v, whole[i][k]), (i, k)
    _same(rstate, state)


def _numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("name,quantized", [("debug-tiny", False), ("debug-tiny", True),
                                            ("debug-baichuan", False)])
def test_export_hf_equals_jax_export_bit_for_bit(tmp_path, name, quantized):
    jc = jconfig.get_config(name)
    tc = get_config(name)
    jp = jllama.init_params(jc, jax.random.PRNGKey(5), dtype=jnp.float32)
    if quantized:
        jp = jllama.quantize_params(jp, J_LAYERWISE)
    tp = params_from_numpy(_numpy_tree(jp))
    assert isinstance(tp["layers"]["wqkv"], QTensor) == quantized
    jax_export_hf(jax.device_get(jp), jc, str(tmp_path / "jax"))
    export_hf(tp, tc, str(tmp_path / "port"))
    want = read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    got = read_safetensors(str(tmp_path / "port" / "model.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k].view(torch.int32), want[k].view(torch.int32)), k
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))
    back = load_hf_checkpoint(str(tmp_path / "port"), tc, dtype=torch.float32, device="cpu")

    def dense(t):
        return t.dequantize(torch.float32) if isinstance(t, QTensor) else t

    want = dict(_leaves(tp))
    for path, a in _leaves(back):
        assert torch.equal(a, dense(want[path]).float()), path
    if quantized:
        with pytest.raises(ValueError, match="dequantize=False"):
            export_hf(tp, tc, str(tmp_path / "refused"), dequantize=False)


def _jax_compare_keys():
    """The per-config keys JAX ``cli/compare.py`` writes (its results dict
    literal and the later delta)."""
    src = (ROOT / "llm_fp8_tpu" / "cli" / "compare.py").read_text()
    block = src[src.index("results[recipes] = {"):]
    block = block[:block.index("}")]
    keys = set(re.findall(r'"(\w+)":', block))
    return keys | set(re.findall(r'r\["(\w+)"\] =', src))


def test_compare_cli_writes_the_jax_keys_and_resumes(tmp_path):
    from llm_fp8_tpu_torch.cli.compare import main

    out = str(tmp_path / "cmp.json")
    base = ["--model_name", "debug-tiny", "--random_init", "--synthetic_samples", "24",
            "--batch_size", "4", "--max_seq_length", "32", "--max_steps", "2",
            "--max_eval_batches", "2", "--device", "cpu", "--out", out]
    first = main(base + ["--configs", "bf16"])
    keys = _jax_compare_keys()
    assert keys >= {"train_wall_s", "perplexity", "stability", "delta_ppl_vs_bf16_pct"}
    assert set(first["bf16"]) == keys and first["bf16"]["steps"] == 2
    merged = main(base + ["--configs", "bf16", "default", "--resume"])
    assert sorted(merged) == ["bf16", "default"]
    assert merged["bf16"]["train_wall_s"] == first["bf16"]["train_wall_s"]  # kept, not rerun
    assert set(merged["default"]) == keys
    assert json.loads(Path(out).read_text()) == json.loads(json.dumps(merged, default=str))
    with pytest.raises(SystemExit, match="not ported yet"):
        main(base + ["--corpus_file", "corpus.txt", "--tokenizer_file", "tok.json"])
