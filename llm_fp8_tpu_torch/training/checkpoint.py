"""Train-state checkpoints with best-loss retention, and the HF export
(counterpart of ``llm_fp8_tpu/training/checkpoint.py``).

The file layout is JAX's: ``ckpt_<step>/`` per saved step, ``meta_<step>.json``
beside it (``{"step", "eval_loss"}``), a copy under ``ckpt_best/`` of the
step with the best eval loss this manager has seen, and all but the newest
``keep`` step checkpoints removed. Where JAX writes Orbax, the port writes
one ``torch.save`` file per step (``ckpt_<step>/state.pt``): the float32
master parameters, the AdamW state (count, moments, the ``MultiSteps``
accumulator), the delayed-scaling state and the step. :meth:`restore`
copies the saved tensors into a template state's own tensors (the
trainer's parameters stay the leaves it differentiates) bit for bit, so a
run resumed from step n continues as the uninterrupted run would.

:func:`export_hf` writes ``model.safetensors`` (float32, HF names, through
``models/hf_loader.py``'s own writer: the port never imports
``safetensors``) and the ``config.json`` JAX writes.

Under a ``torch.distributed`` world (a state of ``DTensor`` slices, the
``Trainer(mesh=)``'s) every rank calls :meth:`~CheckpointManager.save`,
:meth:`~CheckpointManager.restore` and :func:`export_hf`: the full tensors
are gathered (a collective), rank 0 writes the same file a single process
writes, and :meth:`restore` copies into each template ``DTensor`` its
rank's slice, on whatever mesh the template lives (a checkpoint saved under
``fsdp 2`` restores under ``dp 2``, as JAX's Orbax restore re-shards).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.hf_loader import export_hf_state_dict, write_safetensors
from ..quant import QTensor

__all__ = ["CheckpointManager", "export_hf"]

_STATE_FILE = "state.pt"


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _plain(x):
    """A train state as nested dicts of detached full tensors (a DTensor's
    gathered: every rank calls this), ints and None."""
    from ..parallel.sharding import full_tensor

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return full_tensor(x).detach()
    return x


def _fill(template, saved, path="state"):
    """``template`` with the values of ``saved`` (its :func:`_plain` form):
    tensors copied into the template's tensors in place (a DTensor's slice
    into its local tensor), dataclasses rebuilt around them, other leaves
    taken from ``saved``."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"{path}: the checkpoint holds {getattr(saved, 'shape', saved)}, "
                             f"the template {tuple(template.shape)}")
        with torch.no_grad():
            if hasattr(template, "to_local"):
                from ..parallel.sharding import slice_of

                local = template.to_local()
                local.copy_(slice_of(saved.to(local.device), template.placements,
                                     template.device_mesh))
            else:
                template.copy_(saved)
        return template
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _fill(getattr(template, f.name), saved[f.name], f"{path}.{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise ValueError(f"{path}: keys {sorted(saved)} in the checkpoint, "
                             f"{sorted(template)} in the template")
        return {k: _fill(v, saved[k], f"{path}/{k}") for k, v in template.items()}
    return saved


class CheckpointManager:
    """Step-tagged train-state checkpoints with best-loss tracking and
    cleanup."""

    def __init__(self, directory: str, *, keep: int = 2):
        self.dir = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._best_loss = float("inf")

    def _path(self, tag) -> str:
        return os.path.join(self.dir, f"ckpt_{tag}")

    def save(self, state, step: int, *, eval_loss: Optional[float] = None) -> str:
        """Write ``state`` as step ``step`` (in a world: every rank calls
        this; rank 0 writes, the others wait for it)."""
        path = self._path(step)
        plain = _plain(state)
        if _rank() == 0:
            os.makedirs(path, exist_ok=True)
            torch.save(plain, os.path.join(path, _STATE_FILE))
            with open(os.path.join(self.dir, f"meta_{step}.json"), "w") as f:
                json.dump({"step": step, "eval_loss": eval_loss}, f)
        if eval_loss is not None and eval_loss < self._best_loss:
            self._best_loss = eval_loss
            if _rank() == 0:
                best = self._path("best")
                if os.path.exists(best):
                    shutil.rmtree(best)
                shutil.copytree(path, best)
        if _rank() == 0:
            self._cleanup()
        _barrier()
        return path

    def restore(self, template, tag="latest"):
        """The state saved under ``tag`` ("latest", a step, or "best"),
        written into ``template`` (a state of the same structure, e.g. a
        fresh ``Trainer.init_state``) and returned."""
        if tag == "latest":
            steps = self._steps()
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
            tag = steps[-1]
        file = os.path.join(self._path(tag), _STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"no checkpoint {tag!r} under {self.dir}")
        saved = torch.load(file, map_location="cpu", weights_only=True)
        return _fill(template, saved)

    def _steps(self):
        return sorted(int(n[5:]) for n in os.listdir(self.dir)
                      if n.startswith("ckpt_") and n[5:].isdigit())

    def _cleanup(self):
        for old in self._steps()[: -self.keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"meta_{old}.json"))
            except OSError:
                pass


def export_hf(params: Dict[str, Any], cfg: ModelConfig, out_dir: str, *,
              dequantize: bool = True) -> str:
    """Write HF-layout ``model.safetensors`` (float32) and ``config.json``
    into ``out_dir``: the Llama family's layout, an MLA config's
    (``kv_lora_rank``) as DeepSeek-V2, or an MoE config's (``num_experts``)
    as Mixtral or, with QK-norm, Qwen3-MoE, with their ``config.json``
    fields. Quantized leaves are dequantized to float32 (the HF layout has
    no scale sidecar); ``dequantize=False`` refuses them. MLA is told apart
    before the ``num_experts`` test, which its config also passes (the JAX
    ``export_hf`` sends an MLA tree to the Mixtral export, which raises)."""
    def deq(tree):
        if isinstance(tree, dict):
            return {k: deq(v) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            if not dequantize:
                raise ValueError("quantized leaf in export with dequantize=False")
            return tree.dequantize(torch.float32)
        return tree

    if dist.is_initialized():  # DTensor slices gathered on every rank, written by rank 0
        from ..parallel.sharding import gather_tree

        params = gather_tree(params)
        if _rank() != 0:
            _barrier()
            return out_dir
        _export(params, cfg, out_dir, deq)
        _barrier()
        return out_dir
    return _export(params, cfg, out_dir, deq)


def _export(params, cfg, out_dir: str, deq) -> str:
    os.makedirs(out_dir, exist_ok=True)
    if hasattr(cfg, "kv_lora_rank"):
        return _export_deepseek(deq(params), cfg, out_dir)
    is_moe = hasattr(cfg, "num_experts")
    if is_moe:
        from ..models.moe import export_mixtral_state_dict, export_qwen3_moe_state_dict

        sd = (export_qwen3_moe_state_dict if cfg.qk_norm else export_mixtral_state_dict)(
            deq(params), cfg)
    else:
        sd = export_hf_state_dict(deq(params), cfg)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), sd)
    # model_type from the architectural features, as JAX derives it, so that
    # transformers reloads with the right class.
    if is_moe and cfg.qk_norm:
        model_type, arch = "qwen3_moe", "Qwen3MoeForCausalLM"
    elif is_moe:
        model_type, arch = "mixtral", "MixtralForCausalLM"
    elif cfg.qk_norm:
        model_type, arch = "qwen3", "Qwen3ForCausalLM"
    elif cfg.qkv_bias:
        model_type, arch = "qwen2", "Qwen2ForCausalLM"
    else:
        model_type, arch = "llama", "LlamaForCausalLM"
    hf_cfg = {
        "architectures": [arch],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
    }
    if is_moe and cfg.qk_norm:
        # Qwen3MoeConfig's names; the expert width is intermediate_size here.
        hf_cfg.update(num_experts=cfg.num_experts, num_experts_per_tok=cfg.num_experts_per_tok,
                      moe_intermediate_size=cfg.intermediate_size,
                      norm_topk_prob=cfg.norm_topk_prob, decoder_sparse_step=1,
                      mlp_only_layers=[], attention_bias=False)
    elif is_moe:
        hf_cfg.update(num_local_experts=cfg.num_experts,
                      num_experts_per_tok=cfg.num_experts_per_tok, sliding_window=None)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return out_dir


def _export_deepseek(params: Dict[str, Any], cfg, out_dir: str) -> str:
    """An MLA tree as HF ``DeepseekV2ForCausalLM``: the tensors of
    ``export_deepseek_state_dict`` and ``DeepseekV2Config``'s fields."""
    from ..models.mla import export_deepseek_state_dict

    write_safetensors(os.path.join(out_dir, "model.safetensors"),
                      export_deepseek_state_dict(params, cfg))
    hf_cfg = {
        "architectures": ["DeepseekV2ForCausalLM"],
        "model_type": "deepseek_v2",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "moe_intermediate_size": cfg.moe_intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_heads,
        "n_routed_experts": cfg.num_experts,
        "n_shared_experts": cfg.n_shared_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
        "first_k_dense_replace": cfg.first_k_dense_replace,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "topk_method": cfg.topk_method,
        "n_group": cfg.n_group,
        "topk_group": cfg.topk_group,
        "norm_topk_prob": False,
        "q_lora_rank": cfg.q_lora_rank,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": cfg.rope_scaling,
        "rms_norm_eps": cfg.rms_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "attention_bias": False,
        "aux_loss_alpha": cfg.router_aux_coef,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    return out_dir
