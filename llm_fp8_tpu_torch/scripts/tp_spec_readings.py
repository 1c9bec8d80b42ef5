"""Where ``tp_spec_kernels``' ``xla`` reading comes from.

``chip_smoke.py``'s ``tp_spec_kernels`` composes the tp 4 ranks of
Llama-3.1-8B (4 layers) and of a Llama-3.2-1B draft (2 layers) over the
mesh-less ``SpecEngine``'s prefills and rounds, and reads their prefill and
verify logits on ``LLM_FP8_QDOT=xla`` against the mesh-less composition, in
units of each row's std. K1 plans its split of K from the product's shape
and the card's SMs (``kernels/quant_matmul.py::launch_plan``): a rank's
shard of a column-parallel product, planned alone, sums its columns in
another float32 order than the whole product does, and the tp forward
therefore plans it as the whole (``planned_as_whole``). This script reads,
without holding anything, each against the mesh-less composition:

  tp          - the tp 4 and tp 2 ranks as the tp forward runs them
                (column-parallel shards planned as the whole product): what
                remains is the split itself (the row-parallel float32 sums
                over the group, the heads' attention, the collectives)
  tp own plan - the same ranks with every shard planned alone
  control     - no tensor parallelism: the mesh-less composition with K1
                planned for another SM count (half, a quarter, four times
                the card: four times plans the whole model's column
                products as the tp 4 shards alone plan theirs); the same
                function, other float32 sums

with the engine's e4m3 target cache, each on the phase's prompts and on a
second prompt set (``--prompt-seeds``).

    python -m llm_fp8_tpu_torch.scripts.tp_spec_readings      # on the card

Prints one JSON object per reading; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompt-seeds", default="2,3",
                    help="comma list of prompt seeds (2: the phase's prompts)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tp_spec_readings: no CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from llm_fp8_tpu_torch.kernels import _build
    from llm_fp8_tpu_torch.kernels import quant_matmul as k1
    from llm_fp8_tpu_torch.parallel.tensor import local_tp_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(json.dumps({"card": cs.nvidia_smi(), "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda")
    sms = k1.num_sms(dev)

    def alone():  # every shard planned as itself
        return _patched(k1, "planned_as_whole", lambda parts: contextlib.nullcontext())

    for seed in (int(s) for s in args.prompt_seeds.split(",")):
        os.environ.pop("LLM_FP8_QDOT", None)
        tcfg, tparams, dcfg, dparams, prompts = cs.tp_spec_models(dev, prompt_seed=seed)
        padded, rounds, _, _ = cs.tp_spec_record(dev, tcfg, tparams, dcfg, dparams, prompts)
        os.environ["LLM_FP8_QDOT"] = "xla"
        tparams, dparams = cs.row_major_layers(tparams), cs.row_major_layers(dparams)
        whole = ([(tparams, tcfg, None)], [(dparams, dcfg, None)])
        ref = cs.tp_spec_compose(*whole, padded, rounds, dev)

        def read(kind, got):
            out = cs.tp_spec_read((got[0], got[2]), (ref[0], ref[2]), kind, lambda o: None)
            rows = torch.cat([cs.tp_row_std(got[0], ref[0]),
                              cs.tp_row_std(got[2], ref[2]).flatten()])
            out.update(prompt_seed=seed, rows_over_0_1=int((rows > 0.1).sum()),
                       p90_row_std=float(rows.quantile(0.9)))
            print(json.dumps(out), flush=True)

        for n in (4, 2):
            ranks = local_tp_ranks(tparams, tcfg, n)
            dranks = local_tp_ranks(dparams, dcfg, n, ranks[0][2].group)
            read(f"tp{n}", cs.tp_spec_compose(ranks, dranks, padded, rounds, dev))
            with alone():
                read(f"tp{n} own plan", cs.tp_spec_compose(ranks, dranks, padded, rounds, dev))
            del ranks, dranks
            torch.cuda.empty_cache()
        for factor in (0.5, 0.25, 4.0):
            with _patched(k1, "num_sms", lambda d: max(1, int(sms * factor))):
                read(f"control, K1 planned for {factor} x the SMs",
                     cs.tp_spec_compose(*whole, padded, rounds, dev))
        del tparams, dparams, whole, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
