"""Why an MoE slice's card-vs-CPU logits differ as they do.

``chip_smoke.py``'s ``moe_slice`` runs Mixtral-8x7B and Qwen3-30B-A3B at
full width cut to 2 layers on the card and on the CPU (LAYERWISE fp8, an
e4m3 ``KVCache``, a 256-token prefill and two decode steps), the CPU taking
the card's experts at every router call. This script reads, without holding
anything:

  slices - that slice (``chip_smoke._moe_slice_check``) for each model on
           the ``xla`` route and on ``fp8native`` with the card's projection
           inputs, each with the e4m3 KVCache and with a bf16 one (are e4m3
           K/V codes a whole step apart part of it?); per pass the logits'
           largest difference in units of their std, the worst prefill rows,
           the routing flips (and on the xla e4m3 pass the free pass, the
           CPU on its own routes)
  bmm    - the expert products' arithmetic: a bf16 ``bmm`` with a float32
           output on the card and the CPU's float32 product of the same
           bf16 values, each against a float64 product, at Mixtral's and
           Qwen3-30B-A3B's expert shapes (largest error over the output's
           largest |value|), and the share of bf16 roundings of the two
           that differ

    python -m llm_fp8_tpu_torch.scripts.moe_slice_readings           # on the card
    python -m llm_fp8_tpu_torch.scripts.moe_slice_readings --parts bmm

Prints one JSON object per reading; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def bmm_readings():
    g = torch.Generator().manual_seed(0)
    out = []
    for E, M, K, N in ((8, 256, 4096, 28672), (8, 256, 14336, 4096), (8, 8, 14336, 4096),
                       (128, 256, 2048, 1536), (128, 256, 768, 2048)):
        a = torch.randn((E, M, K), generator=g).bfloat16()
        b = (torch.randn((E, K, N), generator=g) * 0.02).bfloat16()
        ref = torch.bmm(a.double(), b.double())
        cpu = torch.bmm(a.float(), b.float())
        card = torch.bmm(a.cuda(), b.cuda(), out_dtype=torch.float32).cpu()
        top = ref.abs().max()
        out.append(dict(shape_EMKN=[E, M, K, N],
                        cpu_err_over_max=float((cpu.double() - ref).abs().max() / top),
                        card_err_over_max=float((card.double() - ref).abs().max() / top),
                        bf16_roundings_differ=float((card.bfloat16() != cpu.bfloat16())
                                                    .float().mean())))
        del a, b, ref, cpu, card
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="slices,bmm")
    parts = ap.parse_args(argv).parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("moe_slice_readings: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from llm_fp8_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(json.dumps({"card": cs.nvidia_smi(), "torch": torch.__version__}), flush=True)
    if "bmm" in parts:
        for r in bmm_readings():
            print(json.dumps({"bmm": r}), flush=True)
    if "slices" in parts:
        cs.check = lambda ok, msg: ok or print(json.dumps({"over_limit": msg}), flush=True)
        dev = torch.device("cuda")

        def log(res):
            print(json.dumps({"slice": res}, default=str), flush=True)

        for model in cs.MOE_SLICE_MODELS:
            for route, forced in (("xla", False), ("fp8native", True)):
                for kv in ("e4m3", "bf16"):
                    cs.pinned(route, lambda: cs._moe_slice_check(dev, log, route, forced, model,
                                                                 kv, free=True))


if __name__ == "__main__":
    main()
