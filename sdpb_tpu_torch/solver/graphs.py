"""The chunked loop's iterations on static buffers: CUDA graphs on the card,
the same body eagerly on the CPU (the counterpart of the JAX package's
jitted lax.scan, sdpb_tpu/solver/step.py::make_chunked_iteration).

The iteration is captured once per (problem, StepConfig) as two graphs,
since the step lengths' eigvalsh checks its result on the host, which a
capture forbids: A runs Iteration.front (through the step lengths'
triangular solves), B runs ChunkedIteration.back (from the eigenvalues
through the update, the stats row and the carry).  An iteration of a chunk
is a replay of A, the eigvalsh calls eagerly on A's outputs, a replay of B.
The state, the stats rows with the carry, the slot counter and
max_iterations are static buffers that the graphs read and update in
place; A and B share one memory pool and are replayed in the order they
were captured.

Before the capture one eager iteration runs on a side stream (the kernels'
first use builds and binds their libraries, the triangular solve sets its
shared-memory attribute), and the buffers are restored after it.  A capture
records the kernel launches of ops/kernels.py without running them: their
counts are taken back out of kernels.LAUNCHES and added at every replay.
A failed capture raises; there is no eager fallback on the card.

In a run of several processes the graphs hold the iteration's NCCL
all-gathers (solver/step.py): the communicator is made by
one eager collective before the capture, and the capture runs in
thread-local mode, so that the process group's watchdog thread may query
its events meanwhile.  gloo's collectives cannot be captured: a chunked run on a card
over gloo (ranks that share a card) raises.
"""
from __future__ import annotations

import ctypes
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.sdp import DeviceSDP
from ..ops import kernels
from .state import SolverState, clone_state
from .step import (ChunkCarry, StepConfig, eigvalsh_all, make_chunked_iteration,
                   state_tensors, stats_layout)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> tuple:
    """(all nodes, kernel nodes) of a captured graph, by libcuda's
    cuGraphGetNodes and cuGraphNodeGetType."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(0)
    n_kernels = 0
    for node in nodes:
        cuda.cuGraphNodeGetType(node, ctypes.byref(kind))
        n_kernels += kind.value == 0        # CU_GRAPH_NODE_TYPE_KERNEL
    return n.value, n_kernels


class ChunkRunner:
    """Runs `chunk` iterations of the chunked body at a time over its own
    copy of the state.  `state` and `carry` (a ChunkCarry, or its float64
    vector on the device) are where it starts; `run()` returns the host
    copy of the stats rows, the last row holding the carry in its first 5
    entries (one device-to-host copy).  On the CPU a chunk ends early once
    the loop has stopped.  Between two run() calls `state` holds the state
    the next chunk starts from, and may be read (a checkpoint) but not
    replaced: the graphs update those tensors in place.  With a group,
    sdp and state are the rank's shards."""

    def __init__(self, sdp: DeviceSDP, cfg: StepConfig, state: SolverState,
                 carry, chunk: int, max_iterations: int, group=None):
        self.sdp, self.cfg, self.chunk, self.group = sdp, cfg, chunk, group
        self.body = make_chunked_iteration(cfg, group)
        dev = sdp.device
        if dev.type == "cuda" and group is not None and group.backend != "nccl":
            raise RuntimeError(
                f"the chunked loop captures the iteration's collectives in CUDA graphs, "
                f"and the {group.backend} backend's cannot be captured (its ranks share a "
                f"card): run them in the host loop (chunk_iterations=1), or one process "
                f"per card over NCCL")
        self.state = clone_state(state)
        self.rows = torch.zeros((chunk + 1, stats_layout(sdp.b).width + 1),
                                dtype=torch.float64, device=dev)
        if not isinstance(carry, torch.Tensor):
            carry = torch.tensor(list(carry), dtype=torch.float64, device=dev)
        self.rows[-1, :len(ChunkCarry._fields)] = carry
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        self.max_iterations = torch.full((), float(max_iterations), dtype=torch.float64,
                                         device=dev)
        self.replays = 0     # iterations run by the last chunk
        self.replay_ms: List[tuple] = []
        self._events = []
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = None
        self.info = {}
        if dev.type == "cuda":
            self._capture()

    # -- the two halves

    def _front(self):
        return self.body.front(self.sdp, self.state)

    def _back(self, front, eigvals) -> None:
        self.body.back(self.sdp, self.state, front, eigvals, self.rows, self.slot,
                       self.max_iterations)

    def _eager(self) -> None:
        front = self._front()
        self._back(front, eigvalsh_all(front.eig_inputs))

    # -- capture and replay

    def _buffers(self) -> List[torch.Tensor]:
        return state_tensors(self.state) + [self.rows, self.slot]

    def _capture(self) -> None:
        dev = self.sdp.device
        if self.group is not None:
            self.group.warm()
        mode = "global" if self.group is None else "thread_local"
        saved = [t.clone() for t in self._buffers()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.time()
        with torch.cuda.stream(side):
            self._eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, s in zip(self._buffers(), saved):
            t.copy_(s)
        del saved
        torch.cuda.synchronize(dev)
        warmup_s = time.time() - t0

        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(kernels.LAUNCHES)
        pool = torch.cuda.graph_pool_handle()
        graph_a = torch.cuda.CUDAGraph(keep_graph=True)
        graph_b = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.time()
        try:
            with torch.cuda.graph(graph_a, pool=pool, capture_error_mode=mode):
                self.front = self._front()
            self.eigvals = [torch.empty(x.sym.shape[:-1], dtype=torch.float64, device=dev)
                            for x in self.front.eig_inputs]
            with torch.cuda.graph(graph_b, pool=pool, capture_error_mode=mode):
                self._back(self.front, self.eigvals)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of the iteration failed: {e}") from e
        finally:
            self.launches = kernels.take_launches(before)
        capture_s = time.time() - t0
        t0 = time.time()
        graph_a.instantiate()
        graph_b.instantiate()
        torch.cuda.synchronize(dev)
        instantiate_s = time.time() - t0
        self.graphs = [graph_a, graph_b]
        nodes = [graph_nodes(g) for g in self.graphs]
        self.info = {
            "warmup_s": warmup_s, "capture_s": capture_s,
            "instantiate_s": instantiate_s,
            "nodes": [n for n, _ in nodes], "kernel_nodes": [k for _, k in nodes],
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "launches_per_replay": {k: v for k, v in self.launches.items() if v},
        }

    def _replay(self) -> None:
        graph_a, graph_b = self.graphs
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        graph_a.replay()
        events[1].record()
        for x, w in zip(self.front.eig_inputs, self.eigvals):
            torch.linalg.eigvalsh(x.sym, out=w)
        events[2].record()
        graph_b.replay()
        events[3].record()
        kernels.add_launches(self.launches)
        self._events.append(events)

    def run(self) -> np.ndarray:
        """One chunk; the host copy of the rows.  On the card
        `replay_ms` then holds each replay's device ms of A, of the
        eigvalsh calls (with the host's sync between them) and of B."""
        self.rows[:-1].zero_()
        self.slot.zero_()
        self.replays = 0
        self._events = []
        for _ in range(self.chunk):
            self.replays += 1
            if self.graphs is not None:
                self._replay()
            else:
                self._eager()
                if self.rows[-1, 3] != 0:
                    break
        rows = self.rows.cpu().numpy().copy()
        self.replay_ms = [tuple(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
                          for ev in self._events]
        return rows

    def snapshot(self):
        """(state, carry) as they stand: where a heal replays from."""
        return clone_state(self.state), self.rows[-1, :len(ChunkCarry._fields)].clone()

    def close(self) -> None:
        """Release the graphs and their memory pool (the state stays)."""
        self.graphs = None
        self.front = self.eigvals = None
        if self.sdp.device.type == "cuda":
            torch.cuda.empty_cache()
