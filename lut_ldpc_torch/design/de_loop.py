"""The iteration loop of the batched DE explorers (design/de_bp_gpu.py,
design/de_lut_gpu.py): the torch counterpart of the lax.while_loop in
lut_ldpc_tpu/design/de_bp_tpu.py and de_lut_tpu.py.

The JAX condition `(it < maxiter) & ~done.all()` becomes a host loop.
Reading `done.all()` is a host sync, so the loop reads it once every
`sync_every` iterations.  Each explorer's body freezes (uniform and reuse
paths) or latches (segmented path) every point that is done, so the
iterations run after the last point decided change nothing the explorer
returns: a read every iteration and a read every k give equal results.

On CUDA the body can be captured once in a CUDA graph and replayed in
place (`graph=True`): the same kernels on the same buffers, one launch an
iteration instead of hundreds.  The graph, its warm-up stream and its
capture stream belong to the card of the state, whichever device is
current: explorers on several cards run their loops in threads of one
process (parallel.run_by_device).  A capture restricts only its own thread
(``thread_local``), and one capture runs at a time in the process.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

__all__ = ["LoopStats", "run_loop"]


@dataclass
class LoopStats:
    """The iterations each loop of an explorer ran (one loop an evolve on
    the uniform and reuse paths, one a run of equal widths and one a
    boundary step on the segmented path).  Explorers on several cards
    share one and append from their threads: ``iterations`` is their
    sum, which does not depend on the order."""

    loops: list = field(default_factory=list)

    @property
    def iterations(self) -> int:
        return sum(self.loops)

    def reset(self) -> None:
        self.loops = []


_capture_lock = threading.Lock()


def _capture(body, state):
    """A CUDA graph of one body call that writes its outputs back into the
    returned static input buffers, so each replay advances them in place;
    captured on the card of `state`, with that card current."""
    dev = state[0].device
    with torch.cuda.device(dev):
        static = tuple(t.clone() for t in state)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(static)  # warm-up: FFT plans, library handles, workspaces
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            with _capture_lock:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = body(static)
                    for s, o in zip(static, out):
                        s.copy_(o)
                finally:
                    graph.capture_end()
        main.wait_stream(side)
    return graph, static


def run_loop(body, state: tuple, n: int, done_of, sync_every: int,
             graph: bool, stats: LoopStats) -> tuple:
    """Apply `body` (a tuple of tensors -> a fresh tuple of the same shapes
    and dtypes) to `state` up to `n` times; stop before an iteration once
    `done_of(state).all()` reads True, which is read every `sync_every`
    iterations (so up to sync_every - 1 iterations run past it)."""
    if n <= 0:
        return state
    cuda_graph = None
    run = 0
    while run < n:
        if bool(done_of(state).all()):
            break
        if graph and cuda_graph is None:
            cuda_graph, state = _capture(body, state)
        m = min(int(sync_every), n - run)
        for _ in range(m):
            if cuda_graph is not None:
                with torch.cuda.device(state[0].device):
                    cuda_graph.replay()
            else:
                state = body(state)
        run += m
    stats.loops.append(run)
    if cuda_graph is not None:
        # the static buffers belong to the graph's pool: hand back copies
        state = tuple(t.clone() for t in state)
    return state
