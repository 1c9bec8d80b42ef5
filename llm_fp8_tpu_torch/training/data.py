"""Data pipeline: OpenMathInstruct-2 chat-template fine-tuning batches (the
numpy parts of ``llm_fp8_tpu/training/data.py``, copied: the port imports
nothing of the JAX package).

The same chat template, truncation at ``max_seq_length``, optional sample
cap, 90/10 train/test split with seed 42, and right-padded batches to a
static bucket length as numpy dicts (``input_ids``, ``attention_mask``).
Loading the HF dataset (``DataManager.load_examples``) and packing a raw
corpus with a ``tokenizers`` file (``load_packed_corpus``) wait for local
data and raise here; ``synthetic_examples`` gives an air-gapped corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["DataConfig", "DataManager", "make_batches", "CHAT_TEMPLATE",
           "ResumableBatches", "load_packed_corpus", "synthetic_examples"]

# The reference uses one template for both Llama and Qwen (its LLAMA_ and
# QWEN_ constants are identical strings, data.py:13-29).
CHAT_TEMPLATE = (
    "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n"
    "You are a helpful assistant that solves math problems step by step. "
    "Please reason step by step, and put your final answer within \\boxed{{}}."
    "\n<|eot_id|>\n"
    "<|start_header_id|>user<|end_header_id|>\n{problem}\n<|eot_id|>\n"
    "<|start_header_id|>assistant<|end_header_id|>\n{solution}<|eot_id|>"
)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "nvidia/OpenMathInstruct-2"
    split_name: str = "train_1M"
    max_seq_length: int = 512
    num_of_samples: Optional[int] = None
    batch_size: int = 8
    eval_batch_size: Optional[int] = None
    test_size: float = 0.1
    seed: int = 42
    pad_to_multiple_of: int = 16

    @property
    def eval_bs(self) -> int:
        return self.eval_batch_size or self.batch_size


class DataManager:
    """Loads, templates, tokenizes and batches the fine-tuning corpus."""

    def __init__(self, config: DataConfig, tokenizer):
        """``tokenizer``: any HF-style tokenizer with ``__call__`` returning
        ``input_ids`` and a ``pad_token_id`` (set to eos if absent, like the
        reference's ``_setup_tokenizer``, data.py:42-47)."""
        self.config = config
        self.tokenizer = tokenizer
        if getattr(tokenizer, "pad_token_id", None) is None and hasattr(
            tokenizer, "eos_token_id"
        ):
            tokenizer.pad_token = tokenizer.eos_token

    # ---- corpus loading ----

    def load_examples(self) -> List[Dict[str, str]]:
        """(problem, generated_solution) rows from HF datasets: waits for
        local data in the port."""
        raise NotImplementedError(
            "DataManager.load_examples (HF datasets) waits for local data in the port; "
            "pass examples to build() or use synthetic_examples()")

    # ---- templating + tokenization ----

    def encode(self, example: Dict[str, str]) -> np.ndarray:
        text = CHAT_TEMPLATE.format(
            problem=example["problem"], solution=example["generated_solution"]
        )
        ids = self.tokenizer(
            text, truncation=True, max_length=self.config.max_seq_length
        )["input_ids"]
        return np.asarray(ids, np.int32)

    def build(self, examples: Optional[Sequence[Dict[str, str]]] = None):
        """Encode + split. Returns (train_seqs, eval_seqs) as token lists."""
        examples = examples if examples is not None else self.load_examples()
        encoded = [self.encode(e) for e in examples]
        rng = np.random.RandomState(self.config.seed)
        idx = rng.permutation(len(encoded))
        n_test = max(1, int(len(encoded) * self.config.test_size))
        test_idx = set(idx[:n_test].tolist())
        train = [encoded[i] for i in range(len(encoded)) if i not in test_idx]
        test = [encoded[i] for i in sorted(test_idx)]
        return train, test

    # ---- batching ----

    def batches(
        self, seqs: Sequence[np.ndarray], batch_size: int, *, shuffle: bool,
        seed: int = 0, pad_token_id: Optional[int] = None,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        pad_id = (
            pad_token_id
            if pad_token_id is not None
            else getattr(self.tokenizer, "pad_token_id", 0) or 0
        )
        yield from make_batches(
            seqs, batch_size,
            max_len=self.config.max_seq_length,
            pad_to_multiple_of=self.config.pad_to_multiple_of,
            pad_token_id=pad_id, shuffle=shuffle, seed=seed,
            drop_last=drop_last,
        )


def make_batches(
    seqs: Sequence[np.ndarray],
    batch_size: int,
    *,
    max_len: int,
    pad_to_multiple_of: int = 16,
    pad_token_id: int = 0,
    shuffle: bool = False,
    seed: int = 0,
    static_shape: bool = True,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Collate: right-pad to a bucket length; mask marks real tokens.

    ``static_shape=True`` pads every batch to ``max_len`` rounded up to the
    multiple — one compiled program for the whole run (the jit equivalent of
    the reference's CUDA-graph-friendly ``pad_to_multiple_of=16`` collator).

    ``drop_last=False`` keeps the trailing partial batch, padded to the full
    ``batch_size`` with all-masked rows (zero attention_mask ⇒ zero weight in
    the token-weighted loss) — eval must see every held-out sequence even
    when the split is smaller than one batch.
    """
    order = np.arange(len(seqs))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    bucket = -(-max_len // pad_to_multiple_of) * pad_to_multiple_of
    starts = list(range(0, len(order) - batch_size + 1, batch_size))
    tail = len(starts) * batch_size
    if not drop_last and tail < len(order):
        starts.append(tail)  # partial chunk, padded with empty rows below
    for start in starts:
        chunk = [seqs[i] for i in order[start : start + batch_size]]
        if not static_shape:
            longest = max(len(s) for s in chunk)
            bucket_len = -(-longest // pad_to_multiple_of) * pad_to_multiple_of
        else:
            bucket_len = bucket
        ids = np.full((batch_size, bucket_len), pad_token_id, np.int32)
        mask = np.zeros((batch_size, bucket_len), np.int32)
        for j, s in enumerate(chunk):
            n = min(len(s), bucket_len)
            ids[j, :n] = s[:n]
            mask[j, :n] = 1
        yield {"input_ids": ids, "attention_mask": mask}


class ResumableBatches:
    """Fault-tolerant batch iterator: checkpointable epoch/position state.

    Parity with the reference's ``RandomFaultTolerantSampler`` /
    ``FaultTolerantDistributedSampler``
    (``training/src/datamodules/fault_tolerant_sampler.py:9-103``): the
    shuffle is a pure function of ``(seed, epoch)``, and the iterator records
    how many batches it has yielded, so a restore reproduces the exact
    remaining stream of the interrupted epoch.
    """

    def __init__(self, seqs, batch_size: int, *, max_len: int,
                 pad_token_id: int = 0, pad_to_multiple_of: int = 16,
                 seed: int = 0):
        self.seqs = seqs
        self.batch_size = batch_size
        self.max_len = max_len
        self.pad_token_id = pad_token_id
        self.pad_to_multiple_of = pad_to_multiple_of
        self.seed = seed
        self.epoch = 0
        self.batch_index = 0

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "batch_index": self.batch_index,
                "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.batch_index = int(state["batch_index"])
        self.seed = int(state["seed"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the remainder of the current epoch (fast-forwarding past
        already-consumed batches), then advance the epoch."""
        batches = list(
            make_batches(
                self.seqs, self.batch_size, max_len=self.max_len,
                pad_to_multiple_of=self.pad_to_multiple_of,
                pad_token_id=self.pad_token_id, shuffle=True,
                seed=self.seed + self.epoch,
            )
        )
        for i in range(self.batch_index, len(batches)):
            self.batch_index = i + 1
            yield batches[i]
        self.epoch += 1
        self.batch_index = 0


def load_packed_corpus(corpus_file: str, tokenizer_file: str, seq_len: int, **_):
    """Pretraining-style packed corpus (``tokenizers`` BPE): waits for local
    data in the port."""
    raise NotImplementedError(
        "load_packed_corpus (a tokenizers file and a raw corpus) waits for local data "
        "in the port")


def synthetic_examples(n: int, seed: int = 0) -> List[Dict[str, str]]:
    """Deterministic math-like corpus for air-gapped tests and benches."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a, b = rng.randint(2, 100, size=2)
        out.append(
            {
                "problem": f"What is {a} times {b}?",
                "generated_solution": (
                    f"To find {a} times {b}, multiply the numbers: "
                    f"{a} * {b} = {a*b}. The answer is \\boxed{{{a*b}}}."
                ),
            }
        )
    return out
