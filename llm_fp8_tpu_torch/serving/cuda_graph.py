"""A serving step captured once as a CUDA graph and replayed: the port's
counterpart of the JAX engines' ``lax.scan`` burst (one dispatch a step,
no Python forward).

The step is a callable ``body()`` that reads and writes only static device
buffers (the engine's tokens, lengths, block tables, caches and outputs) and
the weights, so a replay repeats it on whatever the host copied into them.

:meth:`StepGraph.capture` first runs the body once on a side stream, so
that every kernel is built and has set its attributes (``nvcc`` and
``cudaFuncSetAttribute`` must not run inside a capture) and cuBLAS has its
workspace; that warm-up's writes to the ``state`` buffers (and the draws
from ``generator``) are then undone. It writes the caches only at the rows
the first replay writes again. Then the body is captured, with Python's
cyclic garbage collector paused: a collection inside the capture can free
another engine's graph, and destroying a graph while one is being captured
invalidates the capture (on the H100, when a harness replaced speculative
engines in a loop). A capture that fails raises: nothing carries on
eagerly.

The kernel wrappers count a launch where they enqueue their kernel, so at
the warm-up and in the capture, never at a replay. :attr:`StepGraph.launches`
holds the counts of the capture, which each replay launches again, and
:attr:`StepGraph.replays` the number of replays.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["StepGraph"]


def _counts() -> Dict[str, int]:
    from ..kernels import launch_counts
    from ..kernels.quant_matmul import quant_matmul

    return dict(launch_counts(), quant_matmul_decode=quant_matmul.decode_launches)


class StepGraph:
    """``body`` captured on the card; ``state`` are the static buffers the
    warm-up restores; ``generator`` is a CUDA generator the body draws from
    (registered with the graph, so every replay draws anew)."""

    def __init__(self, body: Callable[[], None], state: Sequence[torch.Tensor],
                 generator: Optional[torch.Generator] = None):
        self._body = body
        self._state = tuple(state)
        self._generator = generator
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.replays = 0
        #: Kernel name → launches in one replay (``quant_matmul_decode``: the
        #: K1 launches that take its decode kernel).
        self.launches: Dict[str, int] = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self) -> None:
        saved = [t.clone() for t in self._state]
        rng = self._generator.get_state() if self._generator is not None else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(self._state, saved):
            t.copy_(s)
        if rng is not None:
            self._generator.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            graph.register_generator_state(self._generator)
        before = _counts()
        # The collector paused (see the module note); torch.cuda.graph
        # collects once before the capture begins.
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._body()
        finally:
            if gc_was_on:
                gc.enable()
        after = _counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self._graph = graph
        self.captures += 1

    def replay(self) -> None:
        self._graph.replay()
        self.replays += 1
