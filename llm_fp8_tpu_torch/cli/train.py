"""Fine-tuning CLI on the card (counterpart of ``llm_fp8_tpu/cli/train.py``;
the Llama, GPT-2, NeoX, Gemma-2, MoE and MLA families, resolved by
``models/registry.py``):

  python -m llm_fp8_tpu_torch.cli.train --model_name meta-llama/Llama-3.2-1B \\
      --random_init --synthetic_samples 400 --mixed_precision fp8 --fp8_scenario default
  python -m llm_fp8_tpu_torch.cli.train --model_name btlm-3b --random_init \\
      --synthetic_samples 400 --mixed_precision bf16 --remat full
  python -m llm_fp8_tpu_torch.cli.train --model_name gemma2-2b --random_init \\
      --synthetic_samples 400 --mixed_precision bf16 --remat dots
  python -m llm_fp8_tpu_torch.cli.train --model_name qwen3-30b-a3b --random_init \\
      --synthetic_samples 400 --mixed_precision bf16 --remat full

``--synthetic_samples N`` trains on the built-in corpus with a byte
tokenizer (the only data path until local data is ported), from random
weights (``--random_init``) or an HF safetensors directory
(``--weights_path``, float32 master weights). On the card the per-channel quantizes of the fp8
dots (the native route's gradients) go through K9. Logs one JSON line per
``--log_every`` steps and per epoch's eval (also appended to
``--log_dir/metrics.jsonl``), checkpoints the train state every
``--save_every`` steps and after each epoch's eval into
``--checkpoint_dir`` (``training/checkpoint.py``: the newest two and the
best eval loss kept), writes the trained model as HF safetensors
(``model.safetensors`` and ``config.json``) and the stability report
(``stability_report.json``) into ``--output_dir``, and prints the report as
the last line. ``--remat none|full|dots`` checkpoints each layer.

A GPT-2/NeoX or Gemma-2 model trains through ``Trainer(forward_fn=...)`` on
the bf16 recipe (``--mixed_precision fp8`` is refused, as in the JAX CLI),
from random weights or a safetensors directory read by its family's packer
(``load_zoo_checkpoint``), with float32 master weights (GPT-2/NeoX compute in
float32, Gemma-2 in bf16 with each dot's weight cast); its trained params are written as the
JAX CLI writes them: ``params.pkl``, a pickle of the stacked tree as numpy
arrays under the JAX package's key names, which either package reads. An
MoE model (Mixtral, Qwen3-MoE) trains the same way with the router's
load-balancing loss in its loss (``Trainer``; the train log carries
``router_aux``), and is written as HF safetensors (``export_hf``), as the JAX
CLI writes it. An MLA model (DeepSeek-V2-Lite, DeepSeek-V2, ``debug-mla*``)
trains as an MoE model and is written as HF ``DeepseekV2ForCausalLM``
safetensors (the JAX CLI's export sends it to the Mixtral export, which
raises; the port tells MLA apart first).

Several cards (or CPU processes): launch one process a device with
``torchrun``, which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``; each rank joins the world (NCCL on
``cuda:LOCAL_RANK``, gloo under ``--device cpu``; ``--multihost`` joins the
same way) and the mesh is built from ``--dp/--fsdp/--cp`` as JAX builds it
(``--fsdp -1`` takes the devices the others leave), then the Llama family
trains through ``Trainer(mesh=)`` (``training/trainer.py``):

  torchrun --nproc_per_node 8 -m llm_fp8_tpu_torch.cli.train \
      --model_name meta-llama/Llama-3.2-1B --random_init --synthetic_samples 4000 \
      --mixed_precision fp8 --dp 2 --fsdp 4
  torchrun --nproc_per_node 2 -m llm_fp8_tpu_torch.cli.train --model_name debug-tiny \
      --random_init --synthetic_samples 40 --device cpu --fsdp 2

Every rank reads the same batches and trains on its rows; rank 0 logs (the
JSON lines, and ``MetricLogger``'s ``--log_dir/metrics.jsonl`` with the
step timer's rates and the device memory), and writes the checkpoints and
the export (gathered from every rank).

Not ported yet (they raise): ``--tp``/``--ep`` above 1 (the next slice:
column/row-parallel products and the experts' all-to-all), a mesh for the
zoo families, ``--use_wandb`` and the HF dataset and tokenizer (no network).
``--unroll`` is a JAX scan knob with no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import math
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fine-tune Llama/Qwen with FP8 on the card",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    g = p.add_argument_group("Model and Data")
    g.add_argument("--model_name", type=str, required=True)
    g.add_argument("--dataset_name", type=str, default="nvidia/OpenMathInstruct-2")
    g.add_argument("--split_name", type=str, default="train_1M")
    g.add_argument("--num_of_samples", type=int, default=None)
    g.add_argument("--weights_path", type=str, default=None,
                   help="an HF safetensors directory (models/hf_loader.py)")
    g.add_argument("--random_init", action="store_true", help="random weights")
    g.add_argument("--synthetic_samples", type=int, default=None,
                   help="use the built-in synthetic corpus with N samples")

    t = p.add_argument_group("Training Hyperparameters")
    t.add_argument("--mixed_precision", type=str, default="bf16", choices=["bf16", "fp8"])
    t.add_argument("--fp8_scenario", type=str, default="default",
                   choices=["default", "mxfp8", "hybrid", "int8_train"])
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--eval_batch_size", type=int, default=None)
    t.add_argument("--max_seq_length", type=int, default=512)
    t.add_argument("--gradient_accumulation_steps", type=int, default=1)
    t.add_argument("--num_epochs", type=int, default=3)
    t.add_argument("--learning_rate", type=float, default=1.41e-5)
    t.add_argument("--num_warmup_steps", type=int, default=100)
    t.add_argument("--schedule", type=str, default="linear",
                   choices=["linear", "cosine", "constant"])
    t.add_argument("--grad_clip", type=float, default=1.0)
    t.add_argument("--remat", type=str, default="none", choices=["none", "full", "dots"],
                   help="per-layer checkpointing: 'full' saves nothing, 'dots' keeps the "
                        "GEMM outputs and recomputes the elementwise ops")
    t.add_argument("--ce_chunks", type=int, default=0,
                   help=">1: fuse the lm_head into a chunked cross-entropy")
    t.add_argument("--unroll", type=int, default=1, help="a JAX scan knob: only 1")
    t.add_argument("--device", type=str, default=None,
                   help="default cuda; 'cpu' runs the plain versions of the kernels")

    m = p.add_argument_group("Mesh (a torchrun world: one process a device)")
    m.add_argument("--dp", type=int, default=1, help="data parallel (parameters replicated)")
    m.add_argument("--fsdp", type=int, default=-1,
                   help="parameter-sharded data parallel; -1 takes the rest of the world")
    m.add_argument("--tp", type=int, default=1, help="tensor parallel: not ported yet")
    m.add_argument("--cp", type=int, default=1,
                   help="context parallel (ring attention over the sequence)")
    m.add_argument("--ep", type=int, default=1, help="expert parallel: not ported yet")
    m.add_argument("--multihost", action="store_true",
                   help="join the world the launcher describes (as torchrun's variables do)")

    lg = p.add_argument_group("Logging and Saving")
    lg.add_argument("--log_dir", type=str, default="./runs")
    lg.add_argument("--output_dir", type=str, default="./saved_model")
    lg.add_argument("--checkpoint_dir", type=str, default=None)
    lg.add_argument("--save_every", type=int, default=0,
                    help="checkpoint every N steps (0: after each epoch's eval only)")
    lg.add_argument("--use_wandb", action="store_true", help="not ported yet")
    lg.add_argument("--wandb_project", type=str, default="llm-fp8-tpu")
    lg.add_argument("--wandb_run_name", type=str, default=None)
    lg.add_argument("--log_every", type=int, default=10)
    return p


def _refuse_unported(args) -> None:
    unported = {
        "--tp/--ep above 1 (tensor and expert parallelism: the next slice, column/row-"
        "parallel products and the experts' all-to-all)": args.tp > 1 or args.ep > 1,
        "--use_wandb": args.use_wandb,
        "--unroll (a JAX scan knob)": args.unroll != 1,
        "the HF dataset (use --synthetic_samples)": not args.synthetic_samples,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise SystemExit(f"not ported yet: {', '.join(asked)}")


class ByteTokenizer:
    """The JAX CLI's synthetic-corpus tokenizer: one id per character."""

    pad_token_id = 0
    eos_token_id = 0

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text, truncation=True, max_length=None):
        return {"input_ids": [ord(c) % (self.vocab_size - 3) + 3 for c in text][:max_length]}


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    import pickle

    import torch

    from ..convert import tree_to_numpy
    from ..models.hf_loader import load_hf_checkpoint
    from ..models.llama import forward as llama_forward
    from ..models.registry import load_zoo_checkpoint, resolve_model
    from ..training import (CheckpointManager, DataConfig, DataManager, StabilityTracker,
                            TrainConfig, Trainer, export_hf, synthetic_examples)
    from ..utils.backend import resolve_device
    from ..utils.metrics import MetricLogger
    from ..utils.monitor import StepTimer, device_memory_stats

    try:
        entry = resolve_model(args.model_name)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e))
    cfg = entry.cfg
    llama = entry.forward_fn is llama_forward
    recipes = args.fp8_scenario if args.mixed_precision == "fp8" else "bf16"
    if recipes != "bf16" and not llama:
        raise SystemExit("--mixed_precision fp8 implements the Llama/Qwen stack; train "
                         f"{args.model_name} with --mixed_precision bf16")
    mesh, rank = None, 0
    if "WORLD_SIZE" in os.environ or args.multihost:
        from ..parallel import MeshConfig, init_world, make_mesh

        if not llama:
            raise SystemExit(f"training over a mesh takes the Llama family, not "
                             f"{args.model_name}")
        own_world = not torch.distributed.is_initialized()
        dev = init_world(args.device)
        try:
            mesh = make_mesh(MeshConfig(dp=args.dp, fsdp=args.fsdp, cp=args.cp, ep=args.ep,
                                        tp=args.tp), dev.type)
        except (AssertionError, ValueError) as e:
            raise SystemExit(f"the mesh does not fit the world: {e}")
        rank = torch.distributed.get_rank()
    else:
        if (args.dp, args.cp) != (1, 1) or args.fsdp > 1:
            raise SystemExit("--dp/--fsdp/--cp above 1 need a world: launch one process a "
                             "device with torchrun")
        dev = resolve_device(args.device)

    dm = DataManager(DataConfig(dataset_name=args.dataset_name, split_name=args.split_name,
                                max_seq_length=args.max_seq_length,
                                num_of_samples=args.num_of_samples,
                                batch_size=args.batch_size,
                                eval_batch_size=args.eval_batch_size),
                     ByteTokenizer(cfg.vocab_size))
    train_seqs, eval_seqs = dm.build(synthetic_examples(args.synthetic_samples))
    steps_per_epoch = len(train_seqs) // args.batch_size
    total_steps = max(steps_per_epoch * args.num_epochs, 1)

    if args.random_init or args.weights_path is None:
        params = entry.init_fn(cfg, dtype=torch.float32, device=dev, seed=0)
    elif llama:
        params = load_hf_checkpoint(args.weights_path, cfg, dtype=torch.float32, device=dev)
    else:
        params = load_zoo_checkpoint(args.model_name, args.weights_path, dtype=torch.float32,
                                     device=dev)
    trainer = Trainer(cfg, TrainConfig(
        learning_rate=args.learning_rate, warmup_steps=args.num_warmup_steps,
        total_steps=total_steps, schedule=args.schedule, grad_clip=args.grad_clip,
        grad_accum=args.gradient_accumulation_steps, recipes=recipes,
        remat={"none": False, "full": True, "dots": "dots"}[args.remat],
        ce_chunks=args.ce_chunks), device=dev,
        forward_fn=None if llama else entry.forward_fn, mesh=mesh)
    if mesh is not None:
        from ..parallel import shard_params

        params = shard_params(params, mesh)
    state = trainer.init_state(params)
    stability = StabilityTracker(precision_name=f"fp8-{args.fp8_scenario}"
                                 if args.mixed_precision == "fp8" else "bf16")
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    world = {} if mesh is None else {"world": torch.distributed.get_world_size(),
                                     "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}
    logger = MetricLogger(args.log_dir) if rank == 0 else None
    timer = StepTimer()

    def log(obj, step, prefix, extra=None):
        if rank == 0:
            print(json.dumps({prefix: {**obj, **(extra or {})}}, default=str), flush=True)
            logger.log(obj, step, prefix=prefix)

    if rank == 0:
        print(json.dumps({"device": str(dev), "steps_per_epoch": steps_per_epoch,
                          "total_steps": total_steps, "recipes": recipes,
                          "remat": args.remat, **world}, default=str), flush=True)
    step = 0
    for epoch in range(args.num_epochs):
        for batch in dm.batches(train_seqs, args.batch_size, shuffle=True, seed=epoch):
            state, m = trainer.train_step(state, batch)
            step += 1
            loss = float(m["loss"])
            timer.step(int(m["tokens"]))
            inst = stability.track_step(loss, grad_norm=float(m["grad_norm"]),
                                        activation_mean=float(m["activation_mean"]),
                                        activation_std=float(m["activation_std"]))
            if step % args.log_every == 0:
                aux = {"router_aux": float(m["router_aux"])} if "router_aux" in m else {}
                log({**inst, "perplexity": math.exp(min(loss, 20.0)), **timer.rates(),
                     "memory_gb": device_memory_stats(dev)["in_use_gb"], "epoch": epoch,
                     **aux}, step, "train", {"step": step})
            if args.save_every and ckpt and step % args.save_every == 0:
                ckpt.save(state, step)
        ev = trainer.evaluate(state.params, dm.batches(eval_seqs, dm.config.eval_bs,
                                                       shuffle=False, drop_last=False))
        log({**ev, "epoch": epoch}, step, "eval", {"step": step})
        if ckpt:
            ckpt.save(state, step, eval_loss=ev["eval_loss"])

    report = stability.report()
    if logger is not None:
        logger.log_summary(report)
        logger.close()
    if llama or hasattr(cfg, "num_experts"):  # MLA configs too: export_hf tells them apart
        export_hf(state.params, cfg, args.output_dir)
        if mesh is not None and own_world:
            torch.distributed.destroy_process_group()
        if rank != 0:
            return report
    else:
        # The zoo families: the raw param tree, as the JAX CLI saves it.
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "params.pkl"), "wb") as f:
            pickle.dump(tree_to_numpy(state.params), f)
    with open(os.path.join(args.output_dir, "stability_report.json"), "w") as f:
        json.dump(report, f, default=str, indent=2)
    print(json.dumps({"stability_report": report}, default=str), flush=True)
    return report


if __name__ == "__main__":
    main()
