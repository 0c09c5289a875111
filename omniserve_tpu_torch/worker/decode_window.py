"""Multi-step greedy decode windows: one decode step over static device
buffers, captured once as a CUDA graph and replayed.

Counterpart of the jitted ``lax.scan`` window of
``omniserve_tpu.worker.model_runner`` (``_build_multi_step_fn``). One step
is: the pages that start at this step's positions (their K stats are reset
under sparse decode), the decode forward, ``argmax``, ``positions += 1``,
and the argmax tokens fed back as the next step's token ids.

Under sparse decode a step either refreshes the page selection (it runs
the selector in every layer and writes the selection buffer) or reuses the
buffer. The JAX scan branches with ``lax.cond``; a captured graph has no
branch, so both steps are captured and ``run`` replays them in the order
the JAX window fixes: the first step's choice comes from the host, step
``i >= 1`` refreshes iff ``i % selector_interval == 0``.

On a CUDA device the steps are captured as ``torch.cuda.CUDAGraph``s when
the window is built, and a failed capture raises: the eager loop never
stands in for the graph on its own. The eager loop runs on the CPU, and on
a card only when the caller asks for it with ``use_graph=False`` (a check
that holds replay against the eager loop). The pools are updated in place.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from omniserve_tpu_torch.models.llama import DecodeBatch, LlamaSpec
from omniserve_tpu_torch.models.mixtral import model_forward
from omniserve_tpu_torch.ops import cuda
from omniserve_tpu_torch.ops.paged_kv import KVPool


class DecodeWindow:
    """Greedy decode over ``b_pad`` slots with ``w``-wide block tables.

    ``page_idxes`` is the runner's selection buffer [L, b_pad, Hkv, budget]
    (sparse decode): refresh steps write it, the others read it. The step
    runs the forward of ``spec``'s model (``mixtral.model_forward``)."""

    def __init__(self, params, pool: KVPool, spec: LlamaSpec, b_pad: int,
                 w: int, device, use_graph: Optional[bool] = None,
                 graph_pool=None, streaming_pool: Optional[KVPool] = None,
                 page_idxes: Optional[torch.Tensor] = None) -> None:
        self.params, self.pool, self.spec = params, pool, spec
        self.streaming_pool = streaming_pool
        self.page_idxes = page_idxes
        if spec.sparse_decode and page_idxes is None:
            raise ValueError("a sparse decode window needs the selection "
                             "buffer")
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
        self.sw = (spec.sink_blocks + spec.local_blocks
                   if spec.sparse_decode else 1)
        self.streaming_block_tables = torch.zeros(
            (b_pad, self.sw), dtype=torch.int32, device=self.device)
        self._rows = torch.arange(b_pad, device=self.device)
        self._staging = torch.zeros(
            3 * b_pad + b_pad * w + b_pad * self.sw, dtype=torch.int32,
            device=self.device)
        # captured steps by "refreshes the selection"; a dense window has
        # only the False one
        self.graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.launches_per_step: Dict[bool, Dict[str, int]] = {}
        self.capture_s = 0.0
        if self.use_graph:
            self._capture(graph_pool)

    def _step(self, refresh: bool) -> None:
        sparse = self.spec.sparse_decode
        new_pages = None
        if sparse:
            # the page a row starts at this position, else -1
            page = self.spec.page_size
            blk = torch.clamp(self.positions // page,
                              max=self.block_tables.shape[1] - 1).long()
            new_pages = torch.where(
                (self.positions % page == 0) & self.active,
                self.block_tables[self._rows, blk], -1)
        batch = DecodeBatch(
            token_ids=self.token_ids, positions=self.positions,
            block_tables=self.block_tables, active=self.active,
            streaming_block_tables=(self.streaming_block_tables if sparse
                                    else None),
            new_page_ids=new_pages, refresh_selection=refresh,
            cached_page_idxes=self.page_idxes)
        logits, _, _, new_sel = model_forward(
            self.params, self.pool, self.streaming_pool, batch, self.spec,
            is_prefill=False)
        if refresh:
            self.page_idxes.copy_(new_sel)
        self.token_ids.copy_(torch.argmax(logits, dim=-1))
        self.positions.add_(1)

    def _capture(self, graph_pool) -> None:
        """Capture the step(s). A warm-up step runs first on a side stream
        (first launches load kernel modules, which a capture must not do),
        with every row inactive: an inactive row reads and writes no live
        page or stat (its append lands on the trash page). The warm-up
        refreshes the selection where the window can, so it runs every
        kernel of both steps; the selection buffer is put back after it."""
        t0 = time.time()
        variants = (True, False) if self.spec.sparse_decode else (False,)
        self.active.zero_()
        keep = None if self.page_idxes is None else self.page_idxes.clone()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._step(variants[0])
        current.wait_stream(side)
        if keep is not None:
            self.page_idxes.copy_(keep)
        for refresh in variants:
            before = dict(cuda.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=graph_pool):
                self._step(refresh)
            # the wrappers counted their launches once while being captured,
            # but capture runs nothing: count them at each replay instead
            per_step = {k: cuda.LAUNCHES[k] - n for k, n in before.items()}
            for k, n in per_step.items():
                cuda.LAUNCHES[k] -= n
            self.graphs[refresh] = graph
            self.launches_per_step[refresh] = per_step
        self.capture_s = time.time() - t0

    def load(self, token_ids: np.ndarray, positions: np.ndarray,
             active: np.ndarray, block_tables: np.ndarray,
             streaming_block_tables: Optional[np.ndarray] = None,
             carry: Optional[torch.Tensor] = None) -> None:
        """One host-to-device upload of a window's metadata into the static
        buffers; ``carry`` (device [B] token ids) replaces ``token_ids``.
        Stream-ordered: a window still queued on the device reads the old
        values."""
        b, w = self.block_tables.shape
        if streaming_block_tables is None:
            streaming_block_tables = np.zeros((b, self.sw), np.int32)
        packed = np.concatenate([
            token_ids, positions, active.astype(np.int32),
            block_tables.ravel(), streaming_block_tables.ravel(),
        ]).astype(np.int32)
        host = torch.from_numpy(packed)
        if self.device.type == "cuda":
            host = host.pin_memory()
        staging = self._staging
        staging.copy_(host, non_blocking=True)
        self.token_ids.copy_(staging[:b] if carry is None else carry)
        self.positions.copy_(staging[b:2 * b])
        torch.ne(staging[2 * b:3 * b], 0, out=self.active)
        o = 3 * b + b * w
        self.block_tables.copy_(staging[3 * b:o].view(b, w))
        self.streaming_block_tables.copy_(staging[o:].view(b, self.sw))

    def _refreshes(self, i: int, refresh_first: bool) -> bool:
        if not self.spec.sparse_decode:
            return False
        if i == 0:
            return refresh_first
        return i % max(1, self.spec.selector_interval) == 0

    def refreshes_in(self, n_steps: int, refresh_first: bool) -> int:
        """How many steps of an ``n_steps`` window refresh the selection."""
        return sum(self._refreshes(i, refresh_first) for i in range(n_steps))

    def run(self, n_steps: int, refresh_first: bool = False) -> torch.Tensor:
        """Advance ``n_steps`` greedy tokens; returns device [n_steps, B]
        token ids (not synchronized)."""
        out = torch.empty((n_steps, self.token_ids.shape[0]),
                          dtype=torch.int64, device=self.device)
        for i in range(n_steps):
            refresh = self._refreshes(i, refresh_first)
            if self.graphs:
                self.graphs[refresh].replay()
                for k, n in self.launches_per_step[refresh].items():
                    cuda.LAUNCHES[k] += n
            else:
                self._step(refresh)
            out[i].copy_(self.token_ids)
        return out
