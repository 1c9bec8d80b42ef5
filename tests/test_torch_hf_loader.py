"""The port's safetensors checkpoint loader against the JAX package's.

Random-weight ``transformers`` models (Llama tied and untied, Qwen2 with q/k/v
biases) are saved with ``save_pretrained`` as one file and as shards with an
index; the JAX ``load_hf_checkpoint`` (through the ``safetensors`` package)
and the port's (its own reader) must give the same bits, bf16 compared as
uint16 views. The port's reader equals ``safetensors.safe_open`` tensor for
tensor, ``export_hf_state_dict`` round-trips and matches JAX's, and the
serving and training CLIs load through ``--weights_path`` on the CPU. The
port never imports ``safetensors``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import hf_loader as jloader
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.models import hf_loader as tloader
from llm_fp8_tpu_torch.models.llama import init_params

ROOT = Path(__file__).resolve().parent.parent

#: name → (the HF architecture, config overrides shared by both packages,
#: the dtype the checkpoint is saved in).
MODELS = {
    "llama_tied": ("llama", dict(tie_word_embeddings=True), torch.bfloat16),
    "llama_untied": ("llama", dict(tie_word_embeddings=False), torch.bfloat16),
    "qwen2_bias": ("qwen2", dict(tie_word_embeddings=False, qkv_bias=True), torch.float32),
}


def _save(kind, tied, dtype, path, shard):
    import transformers

    common = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=tied)
    torch.manual_seed(0)
    if kind == "llama":
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(head_dim=32, **common))
    else:
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**common))
    with torch.no_grad():  # norms and biases away from their 1/0 init
        for name, p in model.named_parameters():
            if "norm" in name or "bias" in name:
                p.add_(torch.randn_like(p) * 0.1)
    model.to(dtype).save_pretrained(path, max_shard_size="100KB" if shard else "1GB")


@pytest.fixture(scope="module", params=[(m, s) for m in MODELS for s in (False, True)],
                ids=lambda p: f"{p[0]}-{'sharded' if p[1] else 'single'}")
def checkpoint(request, tmp_path_factory):
    name, shard = request.param
    kind, over, dtype = MODELS[name]
    path = tmp_path_factory.mktemp(f"{name}_{int(shard)}")
    _save(kind, over["tie_word_embeddings"], dtype, path, shard)
    has_index = (path / "model.safetensors.index.json").exists()
    assert has_index == shard
    return path, over


def _configs(over):
    return (dataclasses.replace(jconfig.get_config("debug-tiny"), **over),
            dataclasses.replace(tconfig.get_config("debug-tiny"), **over))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_port_loader_matches_jax_bit_for_bit(checkpoint):
    path, over = checkpoint
    jcfg, tcfg = _configs(over)
    want = _flat(jloader.load_hf_checkpoint(str(path), jcfg, dtype=jnp.bfloat16))
    got = _flat(tloader.load_hf_checkpoint(str(path), tcfg, dtype=torch.bfloat16, device="cpu"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape), name
        wb = np.asarray(jax.device_get(w)).view(np.uint16)
        np.testing.assert_array_equal(g.view(torch.int16).numpy().view(np.uint16), wb,
                                      err_msg=name)


def test_reader_equals_safe_open(checkpoint):
    from safetensors import safe_open

    path, _ = checkpoint
    files = sorted(path.glob("*.safetensors"))
    assert files
    for f in files:
        mine = tloader.read_safetensors(str(f))
        with safe_open(str(f), framework="pt") as ref:
            assert sorted(mine) == sorted(ref.keys())
            for name in ref.keys():
                r = ref.get_tensor(name)
                m = mine[name]
                assert m.dtype == r.dtype and m.shape == r.shape, name
                assert torch.equal(m.view(torch.int16) if m.dtype == torch.bfloat16 else m,
                                   r.view(torch.int16) if r.dtype == torch.bfloat16 else r), name


def test_export_round_trips_and_matches_jax():
    jcfg, tcfg = _configs(dict(qkv_bias=True, tie_word_embeddings=False))
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    jp["layers"]["bqkv"] = jax.random.normal(jax.random.PRNGKey(4), jp["layers"]["bqkv"].shape)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    want = jloader.export_hf_state_dict(jp, jcfg)
    got = tloader.export_hf_state_dict(tp, tcfg)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    back = _flat(tloader.pack_hf_state_dict(got, tcfg, dtype=torch.float32, device="cpu"))
    for name, t in _flat(tp).items():
        assert torch.equal(back[name], t), name


def _write_safetensors(path, tensors):
    """A minimal writer (the reader's format): header, then raw bytes."""
    header, chunks, off = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.int16).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + b"".join(chunks))


def test_serve_cli_weights_path_serves_like_the_same_params_in_memory(tmp_path):
    from llm_fp8_tpu_torch.cli.serve import main

    cfg = tconfig.get_config("debug-tiny")
    params = init_params(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in tloader.export_hf_state_dict(params, cfg).items()}
    _write_safetensors(tmp_path / "model.safetensors", sd)
    loaded = _flat(tloader.load_hf_checkpoint(str(tmp_path), cfg, device="cpu"))
    for name, t in _flat(params).items():
        assert torch.equal(loaded[name].view(torch.int16), t.view(torch.int16)), name
    common = ["--model_name", "debug-tiny", "--precision", "fp8", "--kv_dtype", "fp8",
              "--device", "cpu", "--num_requests", "3", "--prompt_len", "10",
              "--max_new_tokens", "5", "--max_seq_len", "64", "--max_slots", "2"]
    from_disk = main(common + ["--weights_path", str(tmp_path)])
    in_memory = main(common + ["--random_init"])
    assert [r.output for r in from_disk] == [r.output for r in in_memory]
    assert all(len(r.output) == 5 for r in from_disk)


def test_train_cli_weights_path_runs_on_the_cpu(tmp_path):
    from llm_fp8_tpu_torch.cli.train import main

    _save("llama", False, torch.bfloat16, tmp_path / "ckpt", False)
    report = main(["--model_name", "debug-tiny", "--weights_path", str(tmp_path / "ckpt"),
                   "--synthetic_samples", "16", "--device", "cpu", "--batch_size", "4",
                   "--max_seq_length", "32", "--num_epochs", "1", "--num_warmup_steps", "1",
                   "--log_dir", str(tmp_path / "runs"), "--output_dir", str(tmp_path / "out")])
    assert report["steps"] > 0 and report["non_finite_steps"] == 0


def test_loader_never_imports_safetensors(tmp_path):
    src = (ROOT / "llm_fp8_tpu_torch" / "models" / "hf_loader.py").read_text()
    assert "import safetensors" not in src and "from safetensors" not in src
    _save("llama", False, torch.bfloat16, tmp_path, True)
    code = ("import sys\n"
            "from llm_fp8_tpu_torch.models import get_config\n"
            "from llm_fp8_tpu_torch.models.hf_loader import load_hf_checkpoint\n"
            "import dataclasses\n"
            "cfg = dataclasses.replace(get_config('debug-tiny'), tie_word_embeddings=False)\n"
            f"p = load_hf_checkpoint({str(tmp_path)!r}, cfg, device='cpu')\n"
            "assert p['lm_head'].shape == (128, 512)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'safetensors'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_reader_rejects_a_truncated_file(tmp_path):
    _write_safetensors(tmp_path / "x.safetensors", {"w": torch.ones((4, 4), dtype=torch.bfloat16)})
    raw = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "y.safetensors").write_bytes(raw[:-8])
    with pytest.raises(ValueError, match="spans bytes"):
        tloader.read_safetensors(str(tmp_path / "y.safetensors"))
    with pytest.raises(FileNotFoundError):
        tloader.load_hf_checkpoint(str(tmp_path / "nothing"), tconfig.get_config("debug-tiny"),
                                   device="cpu")


def test_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = tconfig.get_config("debug-tiny")
    sd = {k: torch.from_numpy(v) for k, v in tloader.export_hf_state_dict(
        init_params(cfg, device="cpu"), cfg).items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloader.pack_hf_state_dict(sd, cfg)
