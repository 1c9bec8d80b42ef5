"""Package rules of the PyTorch/CUDA port, checked without a card.

* The port and ``chip_smoke.py`` import no JAX, no ``ml_dtypes`` and nothing
  of ``llm_fp8_tpu`` (checked in a fresh interpreter).
* Entry points default to the card: without CUDA and without ``device=``
  they raise and name ``device="cpu"``.
* Dispatch is by the tensors' device: CPU tensors take the plain versions and
  no kernel launch is counted; importing the kernels builds nothing.
* ``cli.serve --paged --device cpu`` serves through the paged engine.
* ``chip_smoke.py`` exits non-zero and prints no result line without a card,
  and when it stands alone in a directory.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "llm_fp8_tpu_torch", "llm_fp8_tpu_torch.utils.backend", "llm_fp8_tpu_torch.quant",
    "llm_fp8_tpu_torch.quant.formats", "llm_fp8_tpu_torch.quant.qtensor",
    "llm_fp8_tpu_torch.quant.recipe", "llm_fp8_tpu_torch.quant.dot",
    "llm_fp8_tpu_torch.kernels", "llm_fp8_tpu_torch.kernels._build",
    "llm_fp8_tpu_torch.kernels._common", "llm_fp8_tpu_torch.kernels.quant_matmul",
    "llm_fp8_tpu_torch.kernels.decode_attention",
    "llm_fp8_tpu_torch.kernels.flash_attention", "llm_fp8_tpu_torch.kernels.paged_attention",
    "llm_fp8_tpu_torch.kernels.flash_attention_bwd", "llm_fp8_tpu_torch.kernels.quantize",
    "llm_fp8_tpu_torch.kernels.rmsnorm", "llm_fp8_tpu_torch.scripts",
    "llm_fp8_tpu_torch.scripts.profile_fwd_parts",
    "llm_fp8_tpu_torch.scripts.kernel_variants",
    "llm_fp8_tpu_torch.quant.delayed", "llm_fp8_tpu_torch.training",
    "llm_fp8_tpu_torch.training.trainer", "llm_fp8_tpu_torch.training.losses",
    "llm_fp8_tpu_torch.training.quant_state", "llm_fp8_tpu_torch.training.data",
    "llm_fp8_tpu_torch.training.stability", "llm_fp8_tpu_torch.cli.train",
    "llm_fp8_tpu_torch.training.checkpoint", "llm_fp8_tpu_torch.cli.compare",
    "llm_fp8_tpu_torch.ops",
    "llm_fp8_tpu_torch.ops.attention", "llm_fp8_tpu_torch.ops.rmsnorm",
    "llm_fp8_tpu_torch.ops.rotary", "llm_fp8_tpu_torch.ops.sampling",
    "llm_fp8_tpu_torch.models", "llm_fp8_tpu_torch.models.config",
    "llm_fp8_tpu_torch.models.llama", "llm_fp8_tpu_torch.serving",
    "llm_fp8_tpu_torch.serving.engine", "llm_fp8_tpu_torch.serving.block_table",
    "llm_fp8_tpu_torch.serving.paged_engine", "llm_fp8_tpu_torch.serving.cuda_graph",
    "llm_fp8_tpu_torch.serving.speculative", "llm_fp8_tpu_torch.serving.spec_engine",
    "llm_fp8_tpu_torch.models.hf_loader", "llm_fp8_tpu_torch.cli.serve",
    "llm_fp8_tpu_torch.convert", "llm_fp8_tpu_torch.models.bert",
    "llm_fp8_tpu_torch.models.vit", "llm_fp8_tpu_torch.ops.varlen",
    "llm_fp8_tpu_torch.ops.split_kv", "llm_fp8_tpu_torch.parallel",
    "llm_fp8_tpu_torch.parallel.mesh", "llm_fp8_tpu_torch.parallel.sharding",
    "llm_fp8_tpu_torch.parallel.collectives", "llm_fp8_tpu_torch.parallel.fsdp",
    "llm_fp8_tpu_torch.parallel.ring_attention", "llm_fp8_tpu_torch.parallel.pipeline",
    "llm_fp8_tpu_torch.utils.metrics", "llm_fp8_tpu_torch.utils.monitor", "chip_smoke",
]


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'llm_fp8_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_no_port_source_mentions_the_jax_package_in_an_import():
    for path in (ROOT / "llm_fp8_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not any(w in s.split() for w in ("jax", "ml_dtypes", "llm_fp8_tpu")) \
                    and "llm_fp8_tpu." not in s and "jax." not in s, (path, line)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from llm_fp8_tpu_torch.models import get_config
    from llm_fp8_tpu_torch.models.llama import init_params
    from llm_fp8_tpu_torch.serving import Engine

    cfg = get_config("debug-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg)
    assert Engine(params, cfg, device="cpu").device.type == "cpu"
    from llm_fp8_tpu_torch.training import TrainConfig, Trainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainConfig(recipes="default"))
    assert Trainer(cfg, TrainConfig(recipes="default"), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name,want", [("auto", torch.bfloat16), ("fp8", torch.float8_e4m3fn),
                                       ("int8", torch.int8), ("bf16", torch.bfloat16),
                                       (torch.float8_e5m2, torch.float8_e5m2)])
def test_resolve_kv_dtype_on_the_cpu(name, want):
    from llm_fp8_tpu_torch.utils import backend

    assert backend.resolve_kv_dtype(name, "cpu") == want
    with pytest.raises(ValueError):
        backend.resolve_kv_dtype("fp4", "cpu")
    card = torch.cuda.is_available()
    assert backend.device_kind() == (torch.cuda.get_device_name(0) if card else "cpu")
    assert backend.native_fp8_matmul() == (card and torch.cuda.get_device_capability(0) >= (8, 9))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    from llm_fp8_tpu_torch.kernels import launch_counts, reset_launch_counts
    from llm_fp8_tpu_torch.kernels._build import BUILD_DIR, KERNELS
    from llm_fp8_tpu_torch.models import forward_decode_arena, forward_paged, get_config
    from llm_fp8_tpu_torch.models.llama import forward, init_params, quantize_params
    from llm_fp8_tpu_torch.quant import LAYERWISE

    def kernel_libs():  # the CUDA libraries (host libraries may be built meanwhile)
        return sorted(p for k in KERNELS for p in BUILD_DIR.glob(f"lib{k}-*.so"))

    reset_launch_counts()
    built_before = kernel_libs()
    cfg = get_config("debug-tiny")
    params = quantize_params(init_params(cfg, device="cpu"), LAYERWISE)
    toks = torch.randint(1, cfg.vocab_size, (2, 8))
    logits, _ = forward(params, toks, cfg, kv_lens=torch.tensor([8, 5]))
    ka = torch.zeros((cfg.num_layers, 2, cfg.num_kv_heads, 16, cfg.head_dim),
                     dtype=torch.float8_e4m3fn)
    va = torch.zeros_like(ka)
    out, _, _ = forward_decode_arena(params, toks[:, :1], cfg, ka, va, torch.tensor([3, 0]))
    kp = torch.zeros((4, cfg.num_layers, cfg.num_kv_heads, 16, cfg.head_dim),
                     dtype=torch.float8_e4m3fn)
    paged, _, _ = forward_paged(params, toks[:, :1], cfg, kp, kp.clone(),
                                torch.tensor([[0, 1], [2, 3]]), torch.tensor([17, 0]))
    assert torch.isfinite(logits).all() and torch.isfinite(out).all()
    assert torch.isfinite(paged).all() and paged.shape == (2, 1, cfg.vocab_size)
    assert launch_counts() == {"quant_matmul": 0, "decode_attention_arena": 0,
                               "flash_attention": 0, "flash_attention_f32": 0,
                               "paged_attention": 0,
                               "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
                               "flash_attention_bwd_f32_dq": 0,
                               "flash_attention_bwd_f32_dkv": 0, "quantize_fused": 0, "flash_attention_fp8": 0,
                               "rmsnorm_residual_fused": 0}
    assert kernel_libs() == built_before


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_serve_cli_prints_the_jax_cli_keys_on_cpu():
    code = ("from llm_fp8_tpu_torch.cli.serve import main\n"
            "main(['--model_name', 'debug-tiny', '--random_init', '--precision', 'fp8', "
            "'--kv_dtype', 'fp8', '--device', 'cpu', '--num_requests', '2', "
            "'--prompt_len', '8', '--max_new_tokens', '3', '--max_slots', '2', "
            "'--max_seq_len', '64'])\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"requests", "generated_tokens", "wall_s", "tokens_per_s", "ttft_p50_s",
            "ttft_p99_s", "peak_memory_gb", "precision", "kv_dtype"} <= set(out)
    assert out["requests"] == 2 and out["generated_tokens"] == 6
    assert out["kv_dtype"] == "float8_e4m3fn"


def test_serve_cli_paged_runs_on_cpu():
    code = ("from llm_fp8_tpu_torch.cli.serve import main\n"
            "main(['--model_name', 'debug-tiny', '--random_init', '--precision', 'fp8', "
            "'--kv_dtype', 'fp8', '--device', 'cpu', '--paged', '--page_size', '32', "
            "'--num_pages', '16', '--num_requests', '3', '--prompt_len', '40', "
            "'--max_new_tokens', '3', '--max_slots', '2', '--max_seq_len', '128'])\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"requests", "generated_tokens", "wall_s", "tokens_per_s", "ttft_p50_s",
            "ttft_p99_s", "peak_memory_gb", "precision", "kv_dtype", "pages_in_use"} <= set(out)
    assert out["requests"] == 3 and out["generated_tokens"] == 9
    assert out["kv_dtype"] == "float8_e4m3fn" and out["pages_in_use"] == 0


@pytest.mark.parametrize("flag", [["--paged", "--draft_model", "debug-tiny"],
                                  ["--paged", "--kv_dtype", "int8"]])
def test_serve_cli_refuses_unported_options(flag):
    from llm_fp8_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit, match="not ported yet|mutually exclusive|kv_scale = 1"):
        main(["--model_name", "debug-tiny", "--random_init", "--device", "cpu", *flag])


def test_sample_uses_the_given_generator():
    from llm_fp8_tpu_torch.ops.sampling import greedy, sample

    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    a = sample(logits, torch.Generator().manual_seed(3), temperature=0.8, top_k=10, top_p=0.9)
    b = sample(logits, torch.Generator().manual_seed(3), temperature=0.8, top_k=10, top_p=0.9)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(sample(logits, None, temperature=0.0), greedy(logits))
