"""Model runner: scheduler metadata -> device batches -> forward -> samples.

Single-device subset of ``omniserve_tpu.worker.model_runner``:

- whole-prompt prefill of the scheduled prompts as one packed batch
  (PyTorch runs eagerly, so no shape buckets are needed);
- chunked prefill in rectangular [B, Tc] chunks when the prompts exceed
  ``chunk_prefill_size``, each chunk attending the paged pool; the same
  path prefills only the suffix of a prompt whose shared prefix is
  already computed;
- one decode step over PERSISTENT BATCH SLOTS (a running sequence keeps its
  slot; inactive slots are masked), with the KV append fused into the
  decode attention, and per-row sampling on the device;
- greedy multi-step decode windows (``worker/decode_window.py``): on a
  card, one decode step captured as a CUDA graph and replayed;
- LServe's decode side (``--sparse-decode-mode``): streaming block tables,
  the pages whose K stats a step resets, and the cached page selection
  with its refresh rule, in single steps and inside windows;
- LServe's prefill side (``--sparse-context-mode``): under both modes a
  long prompt prefills in chunks clamped to what the widened ring holds
  beside the ctx-local window, each chunk carrying its streaming table.

Models: the Llama family (``LlamaForCausalLM`` and its kin, Qwen2) and
Mixtral (``MixtralForCausalLM``: ``models/mixtral.py``, the same trunk
with a MoE MLP block), as the JAX runner dispatches them.

Weights: ``load_format="dummy"`` draws random packed weights; any other
format loads the model directory's HF checkpoint (or, for the Llama
family, ``packed.npz``; ``models/weight_loader.py``), with its per-tensor
KV scales.

Everything outside the slice raises ``NotImplementedError`` naming its
ROADMAP.md item: TP/PP/SP/DP/EP.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omniserve_tpu_torch import csrc
from omniserve_tpu_torch.config import (
    CacheConfig,
    ModelConfig,
    ParallelConfig,
    SchedulerConfig,
)
from omniserve_tpu_torch.models import llama, mixtral
from omniserve_tpu_torch.models.llama import DecodeBatch, LlamaSpec, PrefillBatch
from omniserve_tpu_torch.ops.sampler import sample
from omniserve_tpu_torch.sequence import (
    SamplerOutput,
    SequenceGroupMetadata,
    SequenceGroupOutput,
    SequenceOutput,
)
from omniserve_tpu_torch.utils.logger import init_logger
from omniserve_tpu_torch.worker.cache_engine import CacheEngine
from omniserve_tpu_torch.worker.decode_window import DecodeWindow

logger = init_logger(__name__)

_DENSE_ARCHS = (
    "LlamaForCausalLM", "MistralForCausalLM", "LLaMAForCausalLM",
    "YiForCausalLM", "Qwen2ForCausalLM",
)


def next_pow2(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def table_width(tables: Sequence[Sequence[int]]) -> int:
    """Padded block-table width: the longest table, at least 4, rounded up
    on a 2-bit-mantissa ladder (4, 6, 8, 10, 12, 14, 16, 20, 24, ...), so
    padding stays under 12.5% while the widths a run meets (and the decode
    graphs it captures) stay few."""
    n = max([4] + [len(t) for t in tables])
    step = max(2, 1 << max(0, (n - 1).bit_length() - 3))
    return -(-n // step) * step


def chunked_prefill_batches(
    seqs: Sequence[Tuple[Sequence[int], Sequence[int]]],
    budget: int,
    page_size: int,
    device,
    starts: Optional[Sequence[int]] = None,
    with_stats: bool = False,
    streaming_tables: Optional[Sequence[Sequence[int]]] = None,
    ring: Optional[Tuple[int, int, int]] = None,
) -> Iterator[Tuple[PrefillBatch, torch.Tensor]]:
    """The chunks of a chunked prefill of ``seqs`` (token ids, block table).

    Geometry of the JAX runner: ``b_pad`` = next power of two of the batch,
    chunk length ``tc = max(page, (budget // b_pad) // page * page)``, a
    rectangular [b_pad, tc] token layout, row i holding tokens
    ``[starts[i] + ci*tc, ...)`` of sequence i. Yields each chunk's
    ``PrefillBatch`` (``context_lens`` = tokens in the pool after the
    chunk) and a device bool [b_pad] marking the rows whose prompt ends in
    it (their ``last_token_idx`` points at the last token). ``with_stats``
    adds ``new_page_ids``: the pages a chunk writes, whose K stats the
    forward resets first. ``ring`` = (sink blocks, ring blocks, ctx-local
    tokens) of a streaming pool: the chunk is clamped so the ring holds
    the ctx-local window plus one chunk, and each batch carries the
    sequences' ``streaming_tables`` as a [b_pad, sink + ring] table."""
    starts = [0] * len(seqs) if starts is None else starts
    b_pad = next_pow2(len(seqs), minimum=1)
    tc = max(page_size, (budget // b_pad) // page_size * page_size)
    st = None
    if ring is not None:
        sink_blocks, local_blocks, ctx_local = ring
        tc = min(tc, max(page_size, (local_blocks * page_size - ctx_local)
                         // page_size * page_size))
        sw = max(1, sink_blocks + local_blocks)
        st = csrc.pad_block_tables(
            [*streaming_tables, *[[]] * (b_pad - len(streaming_tables))], sw)
    n_chunks = -(-max(len(ids) - s for (ids, _), s in zip(seqs, starts))
                 // tc)
    w = next_pow2(max(len(tbl) for _, tbl in seqs), minimum=4)
    bt = csrc.pad_block_tables(
        [tbl for _, tbl in seqs] + [[]] * (b_pad - len(seqs)), w)
    full_lens = np.zeros(b_pad, np.int32)
    for i, (ids, _) in enumerate(seqs):
        full_lens[i] = len(ids)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    bt_dev, lens_dev = dev(bt), dev(full_lens)
    st_dev = None if st is None else dev(st)
    for ci in range(n_chunks):
        tokens = np.zeros((b_pad, tc), np.int64)
        pos = np.zeros((b_pad, tc), np.int32)
        seg = np.full((b_pad, tc), -1, np.int32)
        ctx = np.zeros(b_pad, np.int32)
        last_idx = np.zeros(b_pad, np.int64)
        ends = np.zeros(b_pad, bool)
        new_pages: List[int] = []
        for i, (ids, tbl) in enumerate(seqs):
            lo = starts[i] + ci * tc
            hi = min(len(ids), lo + tc)
            if hi <= lo:
                ctx[i] = len(ids)
                continue
            n = hi - lo
            tokens[i, :n] = ids[lo:hi]
            pos[i, :n] = np.arange(lo, hi)
            seg[i, :n] = i
            ctx[i] = hi
            if hi == len(ids):
                ends[i] = True
                last_idx[i] = i * tc + n - 1
            new_pages.extend(tbl[lo // page_size: (hi - 1) // page_size + 1])
        batch = PrefillBatch(
            token_ids=dev(tokens.reshape(-1)), positions=dev(pos.reshape(-1)),
            segment_ids=dev(seg.reshape(-1)), block_tables=bt_dev,
            last_token_idx=dev(last_idx), seq_lens=lens_dev,
            context_lens=dev(ctx),
            streaming_block_tables=st_dev,
            new_page_ids=(dev(np.asarray(new_pages, np.int32))
                          if with_stats else None),
        )
        yield batch, dev(ends)


class ModelRunner:
    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        parallel_config: Optional[ParallelConfig] = None,
        sp_attn_config=None,
        load_format: str = "auto",
        device="cuda:0",
    ) -> None:
        self.model_config = model_config
        self.cache_config = cache_config
        self.scheduler_config = scheduler_config
        self.device = torch.device(device)
        if parallel_config is not None and parallel_config.world_size > 1:
            raise NotImplementedError(
                "tensor/pipeline/sequence/data parallelism is ROADMAP.md "
                "queue 1 item 10; the port serves on one device"
            )
        arch = (getattr(model_config.hf_config, "architectures", None)
                or ["LlamaForCausalLM"])[0]
        is_moe = arch == "MixtralForCausalLM"
        if not is_moe and arch not in _DENSE_ARCHS:
            raise NotImplementedError(f"architecture {arch} not supported yet")
        # the model's module: its random draw (and, below, its loader)
        model = mixtral if is_moe else llama
        spec_cls = mixtral.MixtralSpec if is_moe else LlamaSpec
        self.spec = spec_cls.from_model_config(
            model_config, sp_attn_config, page_size=cache_config.page_size,
        )
        # before any weight is read: a model the device cannot serve fails
        # here, not after minutes of loading
        self.spec.check_supported(self.device)
        retrieval_flags = head_rank = None
        if sp_attn_config is not None and sp_attn_config.enable_streaming:
            retrieval_flags = sp_attn_config.retrieval_head_flags
            head_rank = sp_attn_config.head_rank_table
        kv_scales = None
        if load_format == "dummy":
            self.params: Dict[str, Any] = model.make_random_packed_params(
                self.spec, seed=model_config.seed, device=self.device,
                retrieval_flags=retrieval_flags, head_rank=head_rank,
            )
        else:
            # an HF checkpoint (or a Llama packed.npz directory)
            from omniserve_tpu_torch.models.weight_loader import (
                load_llama_params,
            )

            load = mixtral.load_mixtral_params if is_moe else load_llama_params
            self.params, kv_scales = load(
                model_config, self.spec, retrieval_flags=retrieval_flags,
                head_rank=head_rank, device=self.device,
            )
        self.cache_engine = CacheEngine(
            model_config, cache_config,
            num_layers=self.spec.num_layers,
            num_kv_heads=self.spec.num_kv_heads,
            head_dim=self.spec.head_dim,
            sp_attn_config=sp_attn_config,
            device=self.device,
        )
        if kv_scales is not None:     # the checkpoint's calibrated scales
            self.cache_engine.load_kv_scales(kv_scales)
        # persistent decode slots
        self._slots: Dict[int, int] = {}
        self._free_slots: List[int] = []
        self._num_slots = 0
        # sparse decode: the page selection [L, b_pad, Hkv, budget] lives in
        # one device buffer that single steps and windows update in place
        self._cached_page_idxes: Optional[torch.Tensor] = None
        self._decode_steps = 0
        self.selector_refreshes = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(model_config.seed)
        # decode windows by (b_pad, table width); on a card each holds one
        # captured decode step, all in one shared graph memory pool
        self._ms_fn_cache: Dict[Tuple[int, int], DecodeWindow] = {}
        self._graph_pool = None
        self.graphs_captured = 0
        self.graph_capture_s = 0.0

    def load_params(self, params: Dict[str, Any], kv_scales=None) -> None:
        """Serve these weights (a port parameter tree on this device, e.g.
        from ``models.convert.params_from_numpy``) instead of the dummy
        ones, and with them a checkpoint's calibrated per-tensor KV scales
        (``(k [L], v [L])``; kept unit without), as the JAX runner hands
        its loader's scales to the cache engine."""
        self.params = params
        if kv_scales is not None:
            self.cache_engine.load_kv_scales(kv_scales)
        self._ms_fn_cache.clear()      # captured steps read the old weights

    @property
    def multi_step_capable(self) -> bool:
        """Whether greedy decode windows can serve this runner: the port
        runs one device, and both the dense and the sparse decode step
        capture as CUDA graphs, so always."""
        return True

    # -- slot management ---------------------------------------------------
    def _slot_for(self, seq_id: int) -> Tuple[int, bool]:
        """(slot, whether the sequence is new to the decode batch)."""
        if seq_id in self._slots:
            return self._slots[seq_id], False
        if not self._free_slots:
            self._free_slots.append(self._num_slots)
            self._num_slots += 1
        slot = self._free_slots.pop(0)
        self._slots[seq_id] = slot
        return slot, True

    def free_seq(self, seq_id: int) -> None:
        slot = self._slots.pop(seq_id, None)
        if slot is not None:
            self._free_slots.append(slot)

    # -- batch preparation -------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prepare_prefill(
        self, metadata: List[SequenceGroupMetadata]
    ) -> Tuple[PrefillBatch, List[int], int]:
        tokens: List[int] = []
        positions: List[int] = []
        segments: List[int] = []
        tables: List[List[int]] = []
        stables: List[List[int]] = []
        last_idx: List[int] = []
        seq_lens: List[int] = []
        seq_ids: List[int] = []
        new_pages: List[int] = []
        for group in metadata:
            for seq_id, data in group.seq_data.items():
                ids = data.get_token_ids()
                seg = len(tables)
                tokens.extend(ids)
                positions.extend(range(len(ids)))
                segments.extend([seg] * len(ids))
                tables.append(group.block_tables[seq_id])
                stables.append(group.streaming_block_tables.get(seq_id, [0]))
                last_idx.append(len(tokens) - 1)
                seq_lens.append(len(ids))
                seq_ids.append(seq_id)
                # as in the JAX runner, the ids of BOTH tables reset K stats
                # of the retrieval pool (the streaming pool keeps none)
                new_pages.extend(group.block_tables[seq_id])
                new_pages.extend(
                    group.streaming_block_tables.get(seq_id, []))
        bt = csrc.pad_block_tables(tables, max(len(t) for t in tables))
        sparse = {}
        if self.spec.sparse_decode:
            sw = max(self.spec.sink_blocks + self.spec.local_blocks,
                     max(len(s) for s in stables))
            sparse = dict(
                streaming_block_tables=self._tensor(
                    csrc.pad_block_tables(stables, sw)),
                new_page_ids=self._tensor(np.asarray(new_pages, np.int32)),
            )
        batch = PrefillBatch(
            token_ids=self._tensor(np.asarray(tokens, np.int64)),
            positions=self._tensor(np.asarray(positions, np.int32)),
            segment_ids=self._tensor(np.asarray(segments, np.int32)),
            block_tables=self._tensor(bt),
            last_token_idx=self._tensor(np.asarray(last_idx, np.int64)),
            seq_lens=self._tensor(np.asarray(seq_lens, np.int32)),
            **sparse,
        )
        return batch, seq_ids, len(tables)

    def _prepare_decode(
        self, metadata: List[SequenceGroupMetadata], device: bool = True
    ):
        """Host batch prep over ``b_pad = next_pow2(slots, 8)`` rows and the
        ``table_width`` ladder. ``device=False`` returns the host arrays
        (a decode window uploads them once, into its static buffers)."""
        entries = []  # (slot, token, position, table, streaming table)
        seq_ids: List[int] = []
        any_new_slot = False
        for group in metadata:
            for seq_id, data in group.seq_data.items():
                slot, is_new = self._slot_for(seq_id)
                any_new_slot |= is_new
                pos = data.get_len() - 1
                table = group.block_tables[seq_id]
                if pos // self.spec.page_size >= len(table):
                    # the decode kernel reads the table on the device
                    raise ValueError(
                        f"sequence {seq_id}: block table of {len(table)} "
                        f"pages does not hold position {pos}"
                    )
                entries.append((
                    slot, data.get_last_token_id(), pos, table,
                    group.streaming_block_tables.get(seq_id, [0]),
                ))
                seq_ids.append(seq_id)
        b_pad = next_pow2(self._num_slots, minimum=8)
        w = table_width([e[3] for e in entries])
        sparse = self.spec.sparse_decode
        sw = self.spec.sink_blocks + self.spec.local_blocks if sparse else 1
        # one C pass (csrc/host_prep.cc); a page is fresh if this step's
        # token starts it
        token_ids, positions, active, bt, st, new_pages, n_new = (
            csrc.build_decode_batch(
                entries, page_size=self.spec.page_size, b_pad=b_pad, w=w,
                sw=sw, max_new_pages=len(entries),
            )
        )
        slots = [e[0] for e in entries]
        refresh = False
        if sparse:
            # selection cache: refresh on the interval or a batch change
            refresh = (
                any_new_slot
                or self._decode_steps % max(1, self.spec.selector_interval)
                == 0
            )
            self._decode_steps += 1
            cache = self._cached_page_idxes
            if cache is None or cache.shape[1] != b_pad:
                self._cached_page_idxes = torch.full(
                    (self.spec.num_layers, b_pad, self.spec.num_kv_heads,
                     self.spec.budget_pages), -1, dtype=torch.int32,
                    device=self.device,
                )
                self._ms_fn_cache.clear()   # windows hold the old buffer
                refresh = True
        if not device:
            host = {"token_ids": token_ids, "positions": positions,
                    "active": active, "bt": bt, "st": st, "w": w,
                    "refresh": refresh}
            return host, seq_ids, slots, b_pad
        npg = new_pages[: max(1, n_new)]
        batch = DecodeBatch(
            token_ids=self._tensor(token_ids.astype(np.int64)),
            positions=self._tensor(positions),
            block_tables=self._tensor(bt),
            active=self._tensor(active),
            streaming_block_tables=self._tensor(st) if sparse else None,
            new_page_ids=self._tensor(npg) if sparse else None,
            refresh_selection=refresh,
            cached_page_idxes=self._cached_page_idxes,
        )
        return batch, seq_ids, slots, b_pad

    # -- sampling ------------------------------------------------------------
    def _sample(
        self,
        logits: torch.Tensor,
        metadata: List[SequenceGroupMetadata],
        rows: List[int],
    ) -> Tuple[np.ndarray, np.ndarray]:
        b = logits.shape[0]
        temps = np.zeros(b, np.float32)
        top_ps = np.ones(b, np.float32)
        top_ks = np.full(b, -1, np.int64)
        i = 0
        for group in metadata:
            sp = group.sampling_params
            for _ in group.seq_data:
                temps[rows[i]] = sp.temperature
                top_ps[rows[i]] = sp.top_p
                top_ks[rows[i]] = sp.top_k
                i += 1
        ids, logprobs = sample(
            logits, self._generator, self._tensor(temps),
            self._tensor(top_ps), self._tensor(top_ks),
        )
        return ids.cpu().numpy(), logprobs.cpu().numpy()

    # -- multi-step decode (greedy) ------------------------------------------
    @torch.inference_mode()
    def start_multi_step(
        self,
        metadata: List[SequenceGroupMetadata],
        n_steps: int,
        pos_offset: int = 0,
        carry_tokens: Optional[torch.Tensor] = None,
    ) -> dict:
        """Launch an ``n_steps`` greedy decode window (async, no fetch).

        ``pos_offset``/``carry_tokens`` let the engine launch the NEXT
        window before draining the current one: host sequence state is
        then one window behind, so positions advance by the in-flight
        window's length and the starting token ids are the previous
        window's DEVICE output (no host round trip on the critical path).
        Block tables must already cover the window (the engine reserves)."""
        host, seq_ids, slots, b_pad = self._prepare_decode(
            metadata, device=False
        )
        use_carry = carry_tokens is not None
        if pos_offset != (n_steps if use_carry else 0):
            raise ValueError("pipelined windows are exactly one window ahead")
        win = self._multi_step_fns(b_pad, host["w"])
        win.load(host["token_ids"], host["positions"] + pos_offset,
                 host["active"], host["bt"], host["st"], carry=carry_tokens)
        tokens = win.run(n_steps, refresh_first=host["refresh"])
        if self.spec.sparse_decode:
            # _prepare_decode already counted the window's first step
            self._decode_steps += n_steps - 1
            self.selector_refreshes += win.refreshes_in(
                n_steps, host["refresh"])
        return {
            "tokens": tokens,             # device [n_steps, B]
            "metadata": metadata,
            "slots": slots,
            "n_steps": n_steps,
        }

    def multi_step_carry(self, handle: dict) -> torch.Tensor:
        """Device [B] token ids at the end of an in-flight window."""
        return handle["tokens"][handle["n_steps"] - 1]

    def finish_multi_step(self, handle: dict) -> List[SamplerOutput]:
        """Fetch a window's tokens and shape them into per-step outputs."""
        toks = handle["tokens"].cpu().numpy()  # [n_steps, B]
        slots = handle["slots"]
        outputs: List[SamplerOutput] = []
        for i in range(handle["n_steps"]):
            step_out: SamplerOutput = []
            row = toks[i][slots]
            k = 0
            for group in handle["metadata"]:
                samples = []
                for seq_id in group.seq_data:
                    samples.append(SequenceOutput(seq_id, int(row[k])))
                    k += 1
                step_out.append(SequenceGroupOutput(samples))
            outputs.append(step_out)
        return outputs

    def execute_model_multi_step(
        self, metadata: List[SequenceGroupMetadata], n_steps: int
    ) -> List[SamplerOutput]:
        """Advance ``n_steps`` greedy decode tokens in one window."""
        return self.finish_multi_step(self.start_multi_step(metadata, n_steps))

    def _multi_step_fns(self, b_pad: int, w: int) -> DecodeWindow:
        """The window of this (batch width, table width), built (and on a
        card captured) on first use. A new batch width drops the others'
        graphs."""
        key = (b_pad, w)
        win = self._ms_fn_cache.get(key)
        if win is None:
            if any(k[0] != b_pad for k in self._ms_fn_cache):
                self._ms_fn_cache.clear()
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            ce = self.cache_engine
            win = DecodeWindow(
                self.params, ce.retrieval_pool, self.spec,
                b_pad, w, self.device, graph_pool=self._graph_pool,
                streaming_pool=ce.streaming_pool,
                page_idxes=self._cached_page_idxes,
            )
            self.graphs_captured += len(win.graphs)
            self.graph_capture_s += win.capture_s
            self._ms_fn_cache[key] = win
        return win

    # -- chunked prefill -----------------------------------------------------
    def _execute_chunked_prefill(self, metadata, budget: int, starts=None):
        """Prefill in rectangular [B, Tc] chunks: each chunk appends its KV
        to the pool, then attends causally over the pool (history + itself)
        through the paged-prefill kernel. ``starts`` (per scheduled seq, in
        metadata order) skips tokens whose KV a COMPUTED shared prefix
        already holds: prefill covers only the suffix. With a streaming
        pool the chunks also write the ring and attend through it."""
        seqs, seq_ids, stables = [], [], []
        for group in metadata:
            for seq_id, data in group.seq_data.items():
                seqs.append((data.get_token_ids(), group.block_tables[seq_id]))
                stables.append(group.streaming_block_tables.get(seq_id, []))
                seq_ids.append(seq_id)
        ring = None
        if self.cache_engine.streaming_pool is not None:
            ring = (self.spec.sink_blocks, self.spec.local_blocks,
                    self.spec.ctx_local)
        final_logits = None
        for batch, ends in chunked_prefill_batches(
            seqs, budget, self.spec.page_size, self.device, starts=starts,
            with_stats=self.spec.with_stats, streaming_tables=stables,
            ring=ring,
        ):
            logits, _, _, _ = mixtral.model_forward(
                self.params, self.cache_engine.retrieval_pool,
                self.cache_engine.streaming_pool, batch, self.spec,
                is_prefill=True,
            )
            final_logits = logits if final_logits is None else torch.where(
                ends[:, None], logits, final_logits
            )
        return final_logits, seq_ids, len(seqs)

    @staticmethod
    def _prefix_starts(metadata):
        """Per-seq prefill start offsets from COMPUTED shared prefixes.

        Returns None when no scheduled sequence can skip anything. A seq
        whose whole prompt is the prefix still prefills its last token
        (its logits seed decoding)."""
        starts, any_skip = [], False
        for group in metadata:
            p = getattr(group, "prefix", None)
            usable = (
                p is not None and p.computed and p.allocated
                and not p.evicted
            )
            for _, data in group.seq_data.items():
                s = 0
                if usable:
                    s = min(p.length, len(data.get_token_ids()) - 1)
                starts.append(max(0, s))
                any_skip = any_skip or s > 0
        return starts if any_skip else None

    # -- execution -----------------------------------------------------------
    @torch.inference_mode()
    def execute_model(
        self, metadata: List[SequenceGroupMetadata]
    ) -> SamplerOutput:
        if not metadata:
            return []
        ce = self.cache_engine                      # pools updated in place
        pool, spool = ce.retrieval_pool, ce.streaming_pool
        if metadata[0].is_prompt:
            total_tokens = sum(
                len(d.get_token_ids())
                for g in metadata for d in g.seq_data.values()
            )
            budget = getattr(self.scheduler_config, "chunk_prefill_size",
                             32000)
            # A streaming ring must hold the ctx-local window plus a chunk
            # for chunked prefill to read it back; the ring of sparse decode
            # alone (sink + decode-local blocks) is too small, so those
            # prompts take the whole-prompt path whatever their length.
            ring_ok = spool is None or (
                self.spec.local_blocks * self.spec.page_size
                >= self.spec.ctx_local + self.spec.page_size
            )
            starts = self._prefix_starts(metadata)
            if spool is not None:
                # a ring's sink/local window is per-sequence state that
                # skipped prefix tokens would never populate
                starts = None
            if starts is not None or (total_tokens > budget and ring_ok):
                # a computed shared prefix: suffix-only prefill through the
                # paged (chunked) path; long prompts: chunked prefill
                logits, seq_ids, n_seqs = self._execute_chunked_prefill(
                    metadata, budget, starts=starts
                )
            else:
                batch, seq_ids, n_seqs = self._prepare_prefill(metadata)
                logits, _, _, _ = mixtral.model_forward(
                    self.params, pool, spool, batch, self.spec,
                    is_prefill=True,
                )
            rows = list(range(n_seqs))
        else:
            batch, seq_ids, rows, _ = self._prepare_decode(metadata)
            logits, _, _, new_sel = mixtral.model_forward(
                self.params, pool, spool, batch, self.spec, is_prefill=False,
            )
            if batch.refresh_selection:
                self._cached_page_idxes.copy_(new_sel)
                self.selector_refreshes += 1
        token_ids, logprobs = self._sample(logits, metadata, rows)

        outputs: SamplerOutput = []
        i = 0
        for group in metadata:
            samples = []
            for seq_id in group.seq_data:
                r = rows[i]
                samples.append(SequenceOutput(
                    seq_id, int(token_ids[r]), float(logprobs[r])
                ))
                i += 1
            outputs.append(SequenceGroupOutput(samples))
        return outputs
