"""Multi-step greedy decode windows: one decode step over static device
buffers, captured once as a CUDA graph and replayed.

Counterpart of the jitted ``lax.scan`` window of
``omniserve_tpu.worker.model_runner`` (``_build_multi_step_fn``). One step
is: the decode forward, ``argmax``, ``positions += 1``, and the argmax
tokens fed back as the next step's token ids. (The JAX step also recomputes
the new-page ids, which reset the sparse selector's per-page stats; the
dense pool keeps no such stats, and the decode kernel finds each row's
target page in the block table itself.)

On a CUDA device the step is captured as a ``torch.cuda.CUDAGraph`` when
the window is built, and a failed capture raises: the eager loop never
stands in for the graph on its own. The eager loop runs on the CPU, and on
a card only when the caller asks for it with ``use_graph=False`` (a check
that holds replay against the eager loop). The pool is updated in place.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from omniserve_tpu_torch.models import llama
from omniserve_tpu_torch.models.llama import DecodeBatch, LlamaSpec
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool


class DecodeWindow:
    """Greedy decode over ``b_pad`` slots with ``w``-wide block tables."""

    def __init__(self, params, pool: KVPool, spec: LlamaSpec, b_pad: int,
                 w: int, device, use_graph: Optional[bool] = None,
                 graph_pool=None) -> None:
        self.params, self.pool, self.spec = params, pool, spec
        self.device = torch.device(device)
        is_cuda = self.device.type == "cuda"
        self.use_graph = is_cuda if use_graph is None else use_graph
        if self.use_graph and not is_cuda:
            raise ValueError("CUDA graphs need a CUDA device")
        # the step's static buffers: every replay reads and updates these
        self.token_ids = torch.zeros(b_pad, dtype=torch.int64,
                                     device=self.device)
        self.positions = torch.zeros(b_pad, dtype=torch.int32,
                                     device=self.device)
        self.block_tables = torch.zeros((b_pad, w), dtype=torch.int32,
                                        device=self.device)
        self.active = torch.zeros(b_pad, dtype=torch.bool, device=self.device)
        self._staging = torch.zeros(3 * b_pad + b_pad * w, dtype=torch.int32,
                                    device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches_per_step: Dict[str, int] = {}
        self.capture_s = 0.0
        if self.use_graph:
            self._capture(graph_pool)

    def _step(self) -> None:
        batch = DecodeBatch(token_ids=self.token_ids, positions=self.positions,
                            block_tables=self.block_tables, active=self.active)
        logits, _, _, _ = llama.llama_forward(
            self.params, self.pool, None, batch, self.spec, is_prefill=False)
        self.token_ids.copy_(torch.argmax(logits, dim=-1))
        self.positions.add_(1)

    def _capture(self, graph_pool) -> None:
        """Capture one step. A warm-up step runs first on a side stream
        (first launches load kernel modules, which a capture must not do),
        with every row inactive: an inactive row reads and writes no KV."""
        t0 = time.time()
        self.active.zero_()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._step()
        current.wait_stream(side)
        before = dict(cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=graph_pool):
            self._step()
        # the wrappers counted their launches once while being captured, but
        # capture runs nothing: count them at each replay instead
        self.launches_per_step = {
            k: cuda.LAUNCHES[k] - n for k, n in before.items()
        }
        for k, n in self.launches_per_step.items():
            cuda.LAUNCHES[k] -= n
        self.graph = graph
        self.capture_s = time.time() - t0

    def load(self, token_ids: np.ndarray, positions: np.ndarray,
             active: np.ndarray, block_tables: np.ndarray,
             carry: Optional[torch.Tensor] = None) -> None:
        """One host-to-device upload of a window's metadata into the static
        buffers; ``carry`` (device [B] token ids) replaces ``token_ids``.
        Stream-ordered: a window still queued on the device reads the old
        values."""
        b, w = self.block_tables.shape
        packed = np.concatenate([
            token_ids, positions, active.astype(np.int32),
            block_tables.ravel(),
        ]).astype(np.int32)
        host = torch.from_numpy(packed)
        if self.device.type == "cuda":
            host = host.pin_memory()
        staging = self._staging
        staging.copy_(host, non_blocking=True)
        self.token_ids.copy_(staging[:b] if carry is None else carry)
        self.positions.copy_(staging[b:2 * b])
        torch.ne(staging[2 * b:3 * b], 0, out=self.active)
        self.block_tables.copy_(staging[3 * b:].view(b, w))

    def run(self, n_steps: int) -> torch.Tensor:
        """Advance ``n_steps`` greedy tokens; returns device [n_steps, B]
        token ids (not synchronized)."""
        out = torch.empty((n_steps, self.token_ids.shape[0]),
                          dtype=torch.int64, device=self.device)
        for i in range(n_steps):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
            out[i].copy_(self.token_ids)
        for k, n in self.launches_per_step.items():
            cuda.LAUNCHES[k] += n * n_steps
        return out
