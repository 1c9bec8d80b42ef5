"""The FP8-vs-BF16 study as a command (counterpart of
``llm_fp8_tpu/cli/compare.py``): train the same model from the same weights
on the same data under each precision config (``bf16``, ``default``
(LAYERWISE), ``hybrid``, ``mxfp8``, ``int8_train``), then compare wall time,
final eval perplexity and the loss statistics.

  python -m llm_fp8_tpu_torch.cli.compare --model_name debug-small --random_init \\
      --synthetic_samples 200 --configs bf16 default hybrid --num_epochs 1

Writes one JSON report to ``--out`` (per config: wall and step times, eval
loss and perplexity, the stability report, and ``delta_ppl_vs_bf16_pct``
once ``bf16`` is in it) after every config, so ``--resume`` can skip the
configs already there and merge. The data is the built-in synthetic corpus
(``--synthetic_samples``) with a byte tokenizer; ``--corpus_file`` /
``--tokenizer_file`` (a packed corpus through a local tokenizer) and the HF
dataset are refused, as in ``cli/train.py``. Runs on the card unless
``--device cpu``. ``--num_layers`` (not in the JAX CLI) cuts the model's
depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="FP8 vs BF16 comparison study")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--num_layers", type=int, default=None,
                   help="train the model cut to its first N layers (default: all)")
    p.add_argument("--weights_path", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--synthetic_samples", type=int, default=None)
    p.add_argument("--dataset_name", type=str, default="nvidia/OpenMathInstruct-2")
    p.add_argument("--split_name", type=str, default="train_1M")
    p.add_argument("--num_of_samples", type=int, default=None)
    p.add_argument("--corpus_file", type=str, default=None,
                   help="not ported: packing a corpus needs a tokenizers-built BPE")
    p.add_argument("--tokenizer_file", type=str, default=None, help="not ported")
    p.add_argument("--max_tokens", type=int, default=None,
                   help="cap the packed-corpus token count")
    p.add_argument("--max_steps", type=int, default=None, help="cap train steps per config")
    p.add_argument("--max_eval_batches", type=int, default=None)
    p.add_argument("--remat", action="store_true", help="remat 'full' per layer")
    p.add_argument("--adam_mu_dtype", type=str, default=None)
    p.add_argument("--param_dtype", type=str, default=None,
                   help="master-weight dtype (default float32)")
    p.add_argument("--resume", action="store_true",
                   help="skip configs already present in --out, merge results")
    p.add_argument("--ramp_steps", type=int, default=0,
                   help="training steps excluded from the steady step_s timing "
                        "(they still train)")
    p.add_argument("--configs", nargs="+", default=["bf16", "default", "hybrid", "mxfp8"],
                   choices=["bf16", "default", "hybrid", "mxfp8", "int8_train"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--num_warmup_steps", type=int, default=10)
    p.add_argument("--out", type=str, default="precision_comparison.json")
    p.add_argument("--device", type=str, default=None,
                   help="default cuda; 'cpu' runs the plain versions of the kernels")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.corpus_file or args.tokenizer_file:
        raise SystemExit("not ported yet: --corpus_file/--tokenizer_file (packing the corpus "
                         "needs the tokenizers package; use --synthetic_samples)")
    if not args.synthetic_samples:
        raise SystemExit("not ported yet: the HF dataset (use --synthetic_samples)")
    import torch

    from ..models.config import get_config
    from ..models.hf_loader import load_hf_checkpoint
    from ..models.llama import init_params
    from ..training import (DataConfig, DataManager, StabilityTracker, TrainConfig, Trainer,
                            synthetic_examples)
    from ..utils.backend import resolve_device
    from .train import ByteTokenizer

    dev = resolve_device(args.device)
    try:
        cfg = get_config(args.model_name)
    except ValueError as e:
        # As JAX's study (its get_config): the Llama family only; the GPT-2
        # and NeoX families train through cli.train.
        raise SystemExit(f"{e} (the FP8-vs-BF16 study takes the Llama family, as the JAX "
                         "package's)")
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    dm = DataManager(DataConfig(dataset_name=args.dataset_name, split_name=args.split_name,
                                max_seq_length=args.max_seq_length,
                                num_of_samples=args.num_of_samples,
                                batch_size=args.batch_size), ByteTokenizer(cfg.vocab_size))
    train_seqs, eval_seqs = dm.build(synthetic_examples(args.synthetic_samples))
    steps_per_epoch = len(train_seqs) // args.batch_size
    total_steps = max(steps_per_epoch * args.num_epochs, 1)
    if args.max_steps is not None:
        total_steps = min(total_steps, args.max_steps)

    # The same initial weights for every config: precision is the only
    # variable.
    if args.random_init or args.weights_path is None:
        base_params = init_params(cfg, dtype=torch.float32, device=dev, seed=0)
    else:
        base_params = load_hf_checkpoint(args.weights_path, cfg, dtype=torch.float32,
                                         device=dev)

    results = {}
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        print(f"resume: found {sorted(results)} in {args.out}", flush=True)

    def copy(tree, dtype):
        if isinstance(tree, dict):
            return {k: copy(v, dtype) for k, v in tree.items()}
        return tree.detach().to(dtype).clone()

    for recipes in args.configs:
        if recipes in results:
            continue
        trainer = Trainer(cfg, TrainConfig(learning_rate=args.learning_rate,
                                           warmup_steps=args.num_warmup_steps,
                                           total_steps=total_steps, recipes=recipes,
                                           remat=args.remat, adam_mu_dtype=args.adam_mu_dtype),
                          device=dev)
        dtype = getattr(torch, args.param_dtype) if args.param_dtype else torch.float32
        state = trainer.init_state(copy(base_params, dtype))
        tracker = StabilityTracker(precision_name=recipes)
        # The step's four metrics stay on the device and are read once after
        # the loop, so steps queue behind one another.
        packed = []
        steps, compile_s, ramp_s = 0, None, None

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        t0 = time.perf_counter()
        for epoch in range(args.num_epochs):
            if steps >= total_steps:
                break
            for batch in dm.batches(train_seqs, args.batch_size, shuffle=True, seed=epoch):
                if steps >= total_steps:
                    break
                state, m = trainer.train_step(state, batch)
                packed.append(torch.stack([m[k].float() for k in (
                    "loss", "grad_norm", "activation_mean", "activation_std")]))
                steps += 1
                if steps == 1:
                    # The first step (kernel builds, allocator warm-up) apart.
                    sync()
                    compile_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                elif steps == 1 + args.ramp_steps and args.ramp_steps:
                    sync()
                    ramp_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
        sync()
        wall = time.perf_counter() - t0
        timed_ramp = args.ramp_steps if steps > args.ramp_steps + 1 else 0
        steady_steps = max(steps - 1 - timed_ramp, 1)
        for row in torch.stack(packed).cpu().tolist():
            tracker.track_step(row[0], grad_norm=row[1], activation_mean=row[2],
                               activation_std=row[3])
        eval_iter = dm.batches(eval_seqs, args.batch_size, shuffle=False, drop_last=False)
        if args.max_eval_batches is not None:
            eval_iter = itertools.islice(eval_iter, args.max_eval_batches)
        ev = trainer.evaluate(state.params, eval_iter)
        results[recipes] = {
            "train_wall_s": round(wall, 2),
            "compile_s": round(compile_s, 2) if compile_s else None,
            "ramp_s": round(ramp_s, 2) if ramp_s else None,
            "step_s": round(wall / steady_steps, 4),
            "steps_per_s": round(steady_steps / wall, 3),
            "steps": steps,
            "eval_loss": ev["eval_loss"],
            "perplexity": ev["perplexity"],
            "stability": tracker.report(),
        }
        var = results[recipes]["stability"]["loss_stats"].get("variance")
        print(f"[{recipes}] wall={wall:.1f}s ppl={ev['perplexity']:.4f} "
              f"loss_var={var if var is None else round(var, 5)}", flush=True)
        # Written after every config: a crash keeps the finished ones.
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        del trainer, state

    if "bf16" in results:
        base_ppl = results["bf16"]["perplexity"]
        for r in results.values():
            r["delta_ppl_vs_bf16_pct"] = round(100.0 * (r["perplexity"] - base_ppl) / base_ppl, 3)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(json.dumps({k: {kk: v[kk] for kk in ("train_wall_s", "perplexity",
                                               "delta_ppl_vs_bf16_pct") if kk in v}
                      for k, v in results.items()}), flush=True)
    return results


if __name__ == "__main__":
    main()
