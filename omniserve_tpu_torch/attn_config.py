"""Sparse-attention configuration (LServe path).

Contract from the reference ``omniserve/attn_config.py``:

- ``CtxAttnConfig``: prefill-phase streaming-head geometry (sink/local token
  windows for the block-sparse prefill masks).
- ``DecAttnConfig``: decode-phase sink/local windows (converted to page
  counts, reference attn_config.py:63-64), hierarchical paging sub-chunks per
  page, the dynamic page-selection token budget, and the selector refresh
  interval.
- ``SpAttnConfig``: loads per-(layer, kv-head) DuoAttention scores from
  ``full_attention_heads.tsv`` and thresholds them at the ``static_sparsity``
  quantile into binary retrieval/streaming flags (reference
  attn_config.py:112-151). A head is STREAMING (sink+local only) if its
  score falls below the quantile threshold.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from omniserve_tpu_torch.utils.constants import PAGE_SIZE, SUB_CHUNKS_PER_PAGE
from omniserve_tpu_torch.utils.logger import init_logger

logger = init_logger(__name__)


class CtxAttnConfig:
    """Prefill (context) phase sparse attention geometry."""

    def __init__(
        self,
        sparse_context_mode: bool = False,
        ctx_sink_size: int = 128,
        ctx_local_size: int = 8192,
        page_size: int = PAGE_SIZE,
    ) -> None:
        self.sparse_context_mode = sparse_context_mode
        self.ctx_sink_size = ctx_sink_size
        self.ctx_local_size = ctx_local_size
        self.page_size = page_size

    @property
    def sink_blocks(self) -> int:
        return math.ceil(self.ctx_sink_size / self.page_size)

    @property
    def local_blocks(self) -> int:
        return math.ceil(self.ctx_local_size / self.page_size)


class DecAttnConfig:
    """Decode phase sparse attention geometry.

    ``sparse_kv_cache_budget`` is the max number of KV tokens any retrieval
    head attends over per step (pages chosen by the query-aware selector);
    ``selector_update_interval`` is how many decode steps a selection is
    reused before being refreshed (reference decoding_attention.py:257-268).
    """

    def __init__(
        self,
        sparse_decode_mode: bool = False,
        dec_sink_size: int = 128,
        dec_local_size: int = 256,
        sub_chunk_per_block: int = SUB_CHUNKS_PER_PAGE,
        sparse_kv_cache_budget: int = 4096,
        selector_update_interval: int = 4,
        multiblock_switch: int = 2048,
        page_size: int = PAGE_SIZE,
    ) -> None:
        self.sparse_decode_mode = sparse_decode_mode
        self.dec_sink_size = dec_sink_size
        self.dec_local_size = dec_local_size
        self.sub_chunk_per_block = sub_chunk_per_block
        self.sparse_kv_cache_budget = sparse_kv_cache_budget
        self.selector_update_interval = selector_update_interval
        # Reference-surface parity only (unused, as in the JAX package): the
        # port's decode kernels split every page list over blocks by
        # ops/cuda/decode_attention.split_plan, from shapes alone.
        self.multiblock_switch = multiblock_switch
        self.page_size = page_size
        self._ring_local_blocks = 0
        if page_size % sub_chunk_per_block != 0:
            raise ValueError("page_size must be divisible by sub_chunk_per_block")
        self.sub_chunk_size = page_size // sub_chunk_per_block

    @property
    def sink_blocks(self) -> int:
        # Derived page counts (reference attn_config.py:63-64).
        return math.ceil(self.dec_sink_size / self.page_size)

    @property
    def local_blocks(self) -> int:
        return math.ceil(self.dec_local_size / self.page_size)

    @property
    def ring_local_blocks(self) -> int:
        """Physical ring capacity in blocks (>= the decode-local window).

        Chunked sparse prefill needs the ring to retain the ctx-local
        window plus one prefill chunk; ``sparse_attn_init`` widens this
        when sparse_context_mode is on. Decode masking still uses the
        (dec_sink_size, dec_local_size) token band regardless of ring
        capacity.
        """
        return max(self.local_blocks, self._ring_local_blocks)

    @property
    def budget_pages(self) -> int:
        return self.sparse_kv_cache_budget // self.page_size


class SpAttnConfig:
    """Static head sparsity: which KV heads are retrieval vs streaming."""

    def __init__(
        self,
        ctx_attn_config: CtxAttnConfig,
        dec_attn_config: DecAttnConfig,
        static_sparsity: float = 0.0,
        attn_pattern_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        scores: Optional[np.ndarray] = None,
    ) -> None:
        self.ctx = ctx_attn_config
        self.dec = dec_attn_config
        self.static_sparsity = float(static_sparsity)

        if scores is None and attn_pattern_path is not None:
            tsv = attn_pattern_path
            if os.path.isdir(tsv):
                tsv = os.path.join(tsv, "full_attention_heads.tsv")
            scores = np.loadtxt(tsv, dtype=np.float32, delimiter="\t")
        if scores is not None:
            scores = np.atleast_2d(np.asarray(scores, dtype=np.float32))
            self.scores = scores
            self.num_layers, self.num_kv_heads = scores.shape
        else:
            if num_layers is None or num_kv_heads is None:
                raise ValueError(
                    "need attn_pattern_path/scores or explicit "
                    "num_layers+num_kv_heads"
                )
            self.num_layers = num_layers
            self.num_kv_heads = num_kv_heads
            self.scores = np.ones((num_layers, num_kv_heads), dtype=np.float32)

        # Threshold at the sparsity quantile: the lowest-scoring
        # `static_sparsity` fraction of ALL heads becomes streaming
        # (reference attn_config.py:112-151).
        if self.static_sparsity > 0.0:
            if np.allclose(self.scores, self.scores.reshape(-1)[0]):
                # no calibration scores (uniform): split by head index so
                # benchmarks without a DuoAttention tsv still get the
                # requested sparsity per layer
                keep = max(1, int(round(
                    self.num_kv_heads * (1.0 - self.static_sparsity)
                )))
                self.retrieval_head_flags = np.zeros_like(
                    self.scores, dtype=bool
                )
                self.retrieval_head_flags[:, :keep] = True
                self.head_rank_table = None  # rebuilt below
                thresh = None
            else:
                # Rank-based selection instead of `scores > quantile`:
                # DuoAttention score files commonly saturate many heads at
                # the same value (e.g. 1.0), and a strict threshold at a
                # tied quantile collapses the retrieval set to ~zero heads
                # (~100% sparsity) instead of the requested fraction. Ties
                # break by head index then layer, spreading tied picks
                # evenly across layers.
                flat = self.scores.reshape(-1)
                n_total = flat.size
                n_keep = max(1, int(round(
                    n_total * (1.0 - self.static_sparsity)
                )))
                lay = np.repeat(np.arange(self.num_layers),
                                self.num_kv_heads)
                hid = np.tile(np.arange(self.num_kv_heads),
                              self.num_layers)
                order = np.lexsort((lay, hid, -flat))
                flags = np.zeros(n_total, dtype=bool)
                flags[order[:n_keep]] = True
                self.retrieval_head_flags = flags.reshape(
                    self.scores.shape
                )
            # Guarantee at least one retrieval head per layer so every layer
            # keeps full-history capability.
            for layer in range(self.num_layers):
                if not self.retrieval_head_flags[layer].any():
                    best = int(np.argmax(self.scores[layer]))
                    self.retrieval_head_flags[layer, best] = True
        else:
            self.retrieval_head_flags = np.ones_like(self.scores, dtype=bool)

        # Rank of each head within its own pool (reference
        # ctx_attn_init.py:58-72): retrieval heads are numbered 0..R-1 in
        # head order; streaming heads 0..S-1.
        self.head_rank_table = np.zeros_like(self.scores, dtype=np.int32)
        for layer in range(self.num_layers):
            r = s = 0
            for h in range(self.num_kv_heads):
                if self.retrieval_head_flags[layer, h]:
                    self.head_rank_table[layer, h] = r
                    r += 1
                else:
                    self.head_rank_table[layer, h] = s
                    s += 1

    # -- accessors ---------------------------------------------------------
    def layer_retrieval_flags(self, layer: int) -> np.ndarray:
        return self.retrieval_head_flags[layer]

    def num_retrieval_heads(self, layer: int) -> int:
        return int(self.retrieval_head_flags[layer].sum())

    def num_streaming_heads(self, layer: int) -> int:
        return self.num_kv_heads - self.num_retrieval_heads(layer)

    def max_retrieval_heads(self) -> int:
        return int(self.retrieval_head_flags.sum(axis=1).max())

    def max_streaming_heads(self) -> int:
        return int(
            (self.num_kv_heads - self.retrieval_head_flags.sum(axis=1)).max()
        )

    def any_streaming(self) -> bool:
        return bool((~self.retrieval_head_flags).any())

    @property
    def enable_streaming(self) -> bool:
        return self.dec.sparse_decode_mode and self.any_streaming()


def sparse_attn_init(
    sparse_context_mode: bool = False,
    sparse_decode_mode: bool = False,
    static_sparsity: float = 0.0,
    attn_pattern_path: Optional[str] = None,
    ctx_sink_size: int = 128,
    ctx_local_size: int = 8192,
    dec_sink_size: int = 128,
    dec_local_size: int = 256,
    sub_chunk_per_block: int = SUB_CHUNKS_PER_PAGE,
    sparse_kv_cache_budget: int = 4096,
    selector_update_interval: int = 4,
    multiblock_switch: int = 2048,
    page_size: int = PAGE_SIZE,
    num_layers: Optional[int] = None,
    num_kv_heads: Optional[int] = None,
    scores: Optional[np.ndarray] = None,
    chunk_prefill_size: int = 0,
    max_model_len: Optional[int] = None,
) -> SpAttnConfig:
    """Build the full sparse-attention config (reference attn_config.py:206)."""
    ctx = CtxAttnConfig(sparse_context_mode, ctx_sink_size, ctx_local_size, page_size)
    dec = DecAttnConfig(
        sparse_decode_mode,
        dec_sink_size,
        dec_local_size,
        sub_chunk_per_block,
        sparse_kv_cache_budget,
        selector_update_interval,
        multiblock_switch,
        page_size,
    )
    can_chunk = max_model_len is None or max_model_len > chunk_prefill_size
    if sparse_context_mode and chunk_prefill_size > 0 and can_chunk:
        # chunked sparse prefill: streaming heads' ctx-local window (plus
        # one in-flight chunk) must survive in the ring across chunks;
        # never more than the model's whole context. Skipped when no
        # prompt can exceed chunk_prefill_size (chunked prefill can never
        # trigger, and the wide ring would inflate the default streaming
        # pool ~45x for short-context serving).
        span = ctx_local_size + chunk_prefill_size
        if max_model_len:
            span = min(span, max_model_len)
        dec._ring_local_blocks = math.ceil(span / page_size)
    return SpAttnConfig(
        ctx,
        dec,
        static_sparsity=static_sparsity,
        attn_pattern_path=attn_pattern_path,
        num_layers=num_layers,
        num_kv_heads=num_kv_heads,
        scores=scores,
    )
