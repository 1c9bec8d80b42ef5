"""HuggingFace safetensors checkpoints → stacked fused-layout params
(counterpart of ``llm_fp8_tpu/models/hf_loader.py``).

Reads a (possibly sharded) safetensors directory, remaps HF names to the
port's layout, fuses QKV into one projection and gate|up into one MLP input
projection, and stacks every layer along a leading axis. Remap table (HF
name → ours), per layer ``i``:

  model.layers.i.self_attn.{q,k,v}_proj.weight  → layers.wqkv[i] (transposed,
      concatenated along the output axis)
  model.layers.i.self_attn.W_pack.weight        → layers.wqkv[i] (Baichuan)
  model.layers.i.self_attn.{q,k,v}_proj.bias    → layers.bqkv[i] (Qwen2.x)
  model.layers.i.self_attn.{q,k}_norm.weight    → layers.{q,k}_norm[i] (Qwen3)
  model.layers.i.self_attn.o_proj.weight        → layers.wo[i]
  model.layers.i.mlp.{gate,up}_proj.weight      → layers.w_gate_up[i]
  model.layers.i.mlp.down_proj.weight           → layers.w_down[i]
  model.layers.i.input_layernorm.weight         → layers.norm_attn[i]
  model.layers.i.post_attention_layernorm.weight→ layers.norm_mlp[i]
  model.embed_tokens.weight                     → embed
  model.norm.weight                             → final_norm
  lm_head.weight                                → lm_head (absent when tied)

HF linear weights are stored ``[out, in]``; ours are ``[in, out]``.

The safetensors format is read here, without the ``safetensors`` package:
an 8-byte little-endian header length, a JSON header mapping each name to
its ``dtype``, ``shape`` and ``data_offsets`` (relative to the end of the
header), then the raw little-endian bytes. Files are memory-mapped
copy-on-write, so a tensor is read from disk when it is first used; BF16
(which numpy lacks) is read as ``uint16`` and viewed as ``torch.bfloat16``.
:func:`write_safetensors` writes the same format (the HF export).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable

import numpy as np
import torch

from ..utils.backend import resolve_device
from .config import ModelConfig

__all__ = ["read_safetensors", "write_safetensors", "load_hf_checkpoint",
           "pack_hf_state_dict", "export_hf_state_dict"]

#: safetensors dtype → (numpy dtype of the stored bytes, torch dtype).
_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn), "F8_E5M2": (np.uint8, torch.float8_e5m2),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    copy-on-write memory map of the file."""
    raw = np.memmap(path, dtype=np.uint8, mode="c")
    if raw.size < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = int.from_bytes(raw[:8].tobytes(), "little")
    if 8 + n > raw.size:
        raise ValueError(f"{path}: header length {n} runs past the file's {raw.size} bytes")
    header = json.loads(raw[8:8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _DTYPES:
            raise TypeError(f"{path}: {name} has dtype {meta['dtype']}, which is not read")
        np_dtype, torch_dtype = _DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        want = int(np.prod(shape, dtype=np.int64)) * np.dtype(np_dtype).itemsize
        if end - start != want or base + end > raw.size:
            raise ValueError(f"{path}: {name} spans bytes {start}..{end}, want {want} "
                             f"bytes of {meta['dtype']} {shape}")
        arr = raw[base + start:base + end]
        if (base + start) % np.dtype(np_dtype).itemsize:
            arr = arr.copy()  # the format does not promise aligned tensors
        t = torch.from_numpy(arr.view(np_dtype).reshape(shape))
        out[name] = t.view(torch_dtype) if t.dtype != torch_dtype else t
    return out


def write_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Write ``{name: tensor or numpy array}`` as one ``.safetensors`` file:
    names in sorted order, tensors back to back, the header padded with
    spaces to a multiple of 8 bytes (as the ``safetensors`` package pads
    it)."""
    by_dtype = {t: name for name, (_, t) in _DTYPES.items() if name not in ("F8_E4M3", "F8_E5M2")}
    by_dtype.update({torch.float8_e4m3fn: "F8_E4M3", torch.float8_e5m2: "F8_E5M2"})
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = torch.as_tensor(tensors[name]).detach().cpu().contiguous()
        if t.dtype not in by_dtype:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        np_dtype = _DTYPES[by_dtype[t.dtype]][0]
        raw = t.view(torch.uint8) if t.element_size() == 1 else t
        data = (raw.view(torch.int16) if t.dtype == torch.bfloat16 else raw).numpy()
        data = np.ascontiguousarray(data).view(np_dtype).tobytes()
        header[name] = {"dtype": by_dtype[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


def _iter_shards(path: str) -> Iterable[str]:
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
        for fn in files:
            yield os.path.join(path, fn)
    else:
        single = os.path.join(path, "model.safetensors")
        if not os.path.exists(single):
            raise FileNotFoundError(f"no safetensors found under {path}")
        yield single


def _load_all(path: str) -> Dict[str, torch.Tensor]:
    out = {}
    for shard in _iter_shards(path):
        out.update(read_safetensors(shard))
    return out


def load_hf_checkpoint(path: str, cfg: ModelConfig, dtype=torch.bfloat16,
                       device=None) -> Dict[str, Any]:
    """Load an HF Llama/Qwen checkpoint directory into stacked params on
    ``device`` (``cuda`` unless given)."""
    return pack_hf_state_dict(_load_all(path), cfg, dtype, device=device)


def pack_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig, dtype=torch.bfloat16,
                       device=None) -> Dict[str, Any]:
    """Remap + fuse + stack an HF state dict (tensors or arrays in memory)."""
    dev = resolve_device(device)

    def get(name):
        if name not in sd:
            raise KeyError(f"missing {name!r} in checkpoint; have e.g. {sorted(sd)[:5]}")
        return torch.as_tensor(sd[name]).to(dev).to(dtype)

    def linear(name):  # HF [out, in] -> ours [in, out]
        return get(name).t()

    wqkv, bqkv, wo, w_gate_up, w_down, n_attn, n_mlp, qn, kn = ([] for _ in range(9))
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        if cfg.fused_wpack:
            # Baichuan: one fused q|k|v [3D, D]; transposed it is our layout.
            wqkv.append(linear(p + "self_attn.W_pack.weight"))
        else:
            wqkv.append(torch.cat([linear(p + f"self_attn.{t}_proj.weight")
                                   for t in ("q", "k", "v")], dim=1))
        if cfg.qkv_bias:
            bqkv.append(torch.cat([get(p + f"self_attn.{t}_proj.bias") for t in ("q", "k", "v")]))
        if cfg.qk_norm:
            qn.append(get(p + "self_attn.q_norm.weight"))
            kn.append(get(p + "self_attn.k_norm.weight"))
        wo.append(linear(p + "self_attn.o_proj.weight"))
        w_gate_up.append(torch.cat([linear(p + "mlp.gate_proj.weight"),
                                    linear(p + "mlp.up_proj.weight")], dim=1))
        w_down.append(linear(p + "mlp.down_proj.weight"))
        n_attn.append(get(p + "input_layernorm.weight"))
        n_mlp.append(get(p + "post_attention_layernorm.weight"))

    layers = {"wqkv": torch.stack(wqkv), "wo": torch.stack(wo),
              "w_gate_up": torch.stack(w_gate_up), "w_down": torch.stack(w_down),
              "norm_attn": torch.stack(n_attn), "norm_mlp": torch.stack(n_mlp)}
    if cfg.qkv_bias:
        layers["bqkv"] = torch.stack(bqkv)
    if cfg.qk_norm:
        layers["q_norm"] = torch.stack(qn)
        layers["k_norm"] = torch.stack(kn)
    params: Dict[str, Any] = {"embed": get("model.embed_tokens.weight"), "layers": layers,
                              "final_norm": get("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = linear("lm_head.weight").contiguous()
    return params


def export_hf_state_dict(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """Inverse remap: stacked fused params → HF names, float32 numpy arrays.
    Quantized leaves must be dequantized by the caller first."""
    lp = params["layers"]
    out: Dict[str, np.ndarray] = {}

    def put(name, t):
        out[name] = t.detach().float().cpu().contiguous().numpy()

    put("model.embed_tokens.weight", params["embed"])
    put("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"].t())
    qd, kvd, inter = cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wqkv = lp["wqkv"][i]
        if cfg.fused_wpack:
            put(p + "self_attn.W_pack.weight", wqkv.t())
        else:
            put(p + "self_attn.q_proj.weight", wqkv[:, :qd].t())
            put(p + "self_attn.k_proj.weight", wqkv[:, qd:qd + kvd].t())
            put(p + "self_attn.v_proj.weight", wqkv[:, qd + kvd:].t())
        if "bqkv" in lp:
            b = lp["bqkv"][i]
            put(p + "self_attn.q_proj.bias", b[:qd])
            put(p + "self_attn.k_proj.bias", b[qd:qd + kvd])
            put(p + "self_attn.v_proj.bias", b[qd + kvd:])
        if "q_norm" in lp:
            put(p + "self_attn.q_norm.weight", lp["q_norm"][i])
            put(p + "self_attn.k_norm.weight", lp["k_norm"][i])
        put(p + "self_attn.o_proj.weight", lp["wo"][i].t())
        gu = lp["w_gate_up"][i]
        put(p + "mlp.gate_proj.weight", gu[:, :inter].t())
        put(p + "mlp.up_proj.weight", gu[:, inter:].t())
        put(p + "mlp.down_proj.weight", lp["w_down"][i].t())
        put(p + "input_layernorm.weight", lp["norm_attn"][i])
        put(p + "post_attention_layernorm.weight", lp["norm_mlp"][i])
    return out
