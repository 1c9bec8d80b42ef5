"""Serving CLI: random init or an HF checkpoint → quantize → continuous-
batching run on the card (counterpart of ``llm_fp8_tpu/cli/serve.py``; the
Llama, GPT-2, NeoX, Gemma-2, MoE and MLA families, resolved by
``models/registry.py``):

  python -m llm_fp8_tpu_torch.cli.serve --model_name llama-3.2-1b --random_init \\
      --precision fp8 --kv_dtype fp8 [--paged --page_size 128 --num_pages 512]
  python -m llm_fp8_tpu_torch.cli.serve --model_name falcon-7b --random_init \\
      --precision fp8 --kv_dtype fp8
  python -m llm_fp8_tpu_torch.cli.serve --model_name llama-3.1-8b \\
      --weights_path DIR --draft_model llama-3.2-1b --draft_weights DIR2 --gamma 4
  python -m llm_fp8_tpu_torch.cli.serve --model_name gemma2-9b --random_init \\
      --precision fp8 --kv_dtype fp8 --draft_model gemma2-2b --max_seq_len 8192
  python -m llm_fp8_tpu_torch.cli.serve --model_name qwen3-30b-a3b --random_init \\
      --precision fp8 --kv_dtype fp8 --draft_model Qwen/Qwen2.5-1.5B

``--weights_path``/``--draft_weights`` read safetensors directories
(``load_zoo_checkpoint``: the family's packer); ``--draft_model`` serves
through the speculative engine (random draft weights from seed 1 unless
``--draft_weights``; any target and draft of one vocabulary, each through
its family's forward: ``SpecEngine(forward_fn=, draft_forward_fn=)``). A
GPT-2/NeoX, Gemma-2, MoE (``mixtral-8x7b``, ``qwen3-30b-a3b``) or MLA model
(``deepseek-v2-lite``, ``deepseek-v2``; their ``debug-*`` configs) serves
through ``Engine(forward_fn=...)``, the slot engine's KVCache path (MLA's
over its latent cache); ``--paged`` is refused for it, as in the JAX CLI,
and so is ``--kv_dtype int8`` (only the Llama family's arena calibrates).
Prints one JSON line with the JAX CLI's keys: tokens/s, p50/p99 TTFT and the
peak device memory (``torch.cuda.max_memory_allocated``); ``--paged`` adds
``pages_in_use``, ``--draft_model`` the ``spec_*`` statistics. ``main``
returns the finished requests.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="FP8 serving benchmark on the card")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--weights_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--precision", type=str, default="fp8",
                   choices=["fp8", "int8", "int4", "bf16"])
    p.add_argument("--fp8_scenario", type=str, default="default",
                   choices=["default", "mxfp8", "hybrid"])
    p.add_argument("--kv_dtype", type=str, default="auto",
                   choices=["auto", "fp8", "bf16", "int8"])
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--max_seq_len", type=int, default=2048)
    p.add_argument("--paged", action="store_true",
                   help="serve through the paged-KV engine (block tables + paged "
                        "decode kernel) instead of the slot arena")
    p.add_argument("--page_size", type=int, default=128)
    p.add_argument("--num_pages", type=int, default=512)
    p.add_argument("--decode_burst", type=int, default=32)
    p.add_argument("--num_requests", type=int, default=16)
    p.add_argument("--prompt_len", type=int, default=128)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    # Speculative decoding: a draft model proposes --gamma tokens per slot a
    # round; the target verifies them in one forward. temperature 0 commits
    # the tokens of plain greedy serving.
    p.add_argument("--draft_model", type=str, default=None,
                   help="serve speculatively with this model as the draft (random "
                        "weights from seed 1 unless --draft_weights)")
    p.add_argument("--draft_weights", type=str, default=None)
    p.add_argument("--gamma", type=int, default=4, help="proposals a round")
    p.add_argument("--spec_top_k", type=int, default=0)
    p.add_argument("--spec_top_p", type=float, default=0.0)
    p.add_argument("--device", type=str, default=None,
                   help="default cuda; 'cpu' runs the plain versions of the kernels")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..models.llama import forward as llama_forward
    from ..models.registry import load_zoo_checkpoint, resolve_model
    from ..quant import recipe_set_by_name
    from ..serving import (Engine, EngineConfig, PagedEngine, PagedEngineConfig,
                           SamplingParams, SpecEngine)
    from ..utils.backend import resolve_device

    if args.paged and args.draft_model is not None:
        raise SystemExit(
            "--paged and --draft_model are mutually exclusive: speculative "
            "decoding runs on the slot-arena engine (SpecEngine), not the "
            "paged pool — see docs/PERF_NOTES.md (speculative serving path)")
    if args.paged and args.kv_dtype == "int8":
        raise SystemExit(
            "--paged with --kv_dtype int8 is refused: the paged engine stores K/V at "
            "kv_scale = 1 (it has no calibration and the CLI no scale flag), so the int8 "
            "pool would hold round(K), mostly zeros; use --kv_dtype fp8 or bf16")
    device = resolve_device(args.device)

    def resolved(name):
        try:
            return resolve_model(name)
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(str(e))

    def params_of(entry, name, weights, seed):
        """bf16 params of ``name``: random from ``seed``, or read from the
        checkpoint directory ``weights``."""
        if weights is None:
            return entry.init_fn(entry.cfg, dtype=torch.bfloat16, device=device, seed=seed)
        return load_zoo_checkpoint(name, weights, dtype=torch.bfloat16, device=device)

    entry = resolved(args.model_name)
    llama = entry.forward_fn is llama_forward
    if args.paged and not llama:
        raise SystemExit("--paged uses the Llama-family paged decode path; serve "
                         f"{args.model_name} through the default (arena) engine")
    cfg = entry.cfg
    params = params_of(entry, args.model_name,
                       None if args.random_init else args.weights_path, seed=0)
    if args.precision == "fp8":
        params = entry.quantize_fn(params, recipe_set_by_name(args.fp8_scenario))
    elif args.precision in ("int8", "int4"):
        params = entry.quantize_fn(params, recipe_set_by_name(args.precision))
    if args.draft_model is not None:
        # The draft's bf16 params come from seed 1, as the JAX CLI's
        # PRNGKey(1); as there, the draft is not quantized.
        dentry = resolved(args.draft_model)
        dparams = params_of(dentry, args.draft_model, args.draft_weights, seed=1)
        eng = SpecEngine(params, cfg, dparams, dentry.cfg,
                         EngineConfig(max_slots=args.max_slots, max_seq_len=args.max_seq_len,
                                      kv_dtype=args.kv_dtype),
                         gamma=args.gamma, temperature=args.temperature,
                         top_k=args.spec_top_k, top_p=args.spec_top_p, device=device,
                         forward_fn=entry.forward_fn, draft_forward_fn=dentry.forward_fn)
    elif args.paged:
        eng = PagedEngine(params, cfg, PagedEngineConfig(
            max_slots=args.max_slots, num_pages=args.num_pages, page_size=args.page_size,
            max_pages_per_seq=-(-args.max_seq_len // args.page_size),
            kv_dtype=args.kv_dtype, decode_burst=args.decode_burst), device=device)
    else:
        eng = Engine(params, cfg, EngineConfig(max_slots=args.max_slots,
                                               max_seq_len=args.max_seq_len,
                                               kv_dtype=args.kv_dtype,
                                               decode_burst=args.decode_burst),
                     device=device, forward_fn=entry.forward_fn)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.RandomState(0)
    sp = SamplingParams(temperature=args.temperature, max_new_tokens=args.max_new_tokens)
    t0 = time.perf_counter()
    for _ in range(args.num_requests):
        eng.add_request(rng.randint(1, cfg.vocab_size, args.prompt_len).astype(np.int32), sp)
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    new_tokens = sum(len(r.output) for r in done)
    ttfts = sorted(r.ttft for r in done if r.ttft is not None)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    spec_stats = {}
    if args.draft_model is not None and eng.accepted_histogram:
        mean = float(np.mean(eng.accepted_histogram))
        spec_stats = {"spec_gamma": args.gamma, "spec_mean_accepted": round(mean, 3),
                      "spec_tokens_per_round": round(mean + 1, 3)}
    print(json.dumps({
        "requests": len(done),
        "generated_tokens": new_tokens,
        "wall_s": round(dt, 3),
        "tokens_per_s": round(new_tokens / dt, 2),
        "ttft_p50_s": round(ttfts[len(ttfts) // 2], 4) if ttfts else None,
        "ttft_p99_s": round(ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))], 4)
        if ttfts else None,
        "peak_memory_gb": round(peak, 3) if peak is not None else None,
        "precision": args.precision,
        "kv_dtype": str(eng.ecfg.kv_dtype).replace("torch.", ""),
        **({"pages_in_use": eng.pages_in_use} if args.paged else {}),
        **spec_stats,
        **({"kv_drift": eng.kv_drift_stats()} if getattr(eng, "_int8_kv", False) else {}),
    }))
    return done


if __name__ == "__main__":
    main()
