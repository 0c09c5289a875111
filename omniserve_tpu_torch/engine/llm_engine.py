"""LLMEngine: request lifecycle + per-iteration step loop.

Port of ``omniserve_tpu.engine.llm_engine`` with the same surface as the
reference ``omniserve/engine/llm_engine.py``:
``from_engine_args`` / ``add_request`` / ``step`` /
``has_unfinished_requests`` / ``abort_request``; IFB (continuous batching,
schedule each step, reference llm_engine.py:541-561) and non-IFB (schedule
once, static batch, :562-592) modes; decoding-simulation via
``DECODING_SIMULATION_LENGTH`` (:349-354); profiling requests with random
token ids (:337-347). With ``decode_multi_step > 1`` greedy decode runs
in windows of that many tokens (on a card, replays of a captured CUDA
graph), static-batch windows pipelined one ahead in benchmarking mode.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Union

import numpy as np

from omniserve_tpu_torch.attn_config import SpAttnConfig
from omniserve_tpu_torch.config import (
    CacheConfig,
    DeviceConfig,
    IFBConfig,
    ModelConfig,
    ParallelConfig,
    ProfilingConfig,
    SchedulerConfig,
)
from omniserve_tpu_torch.core.scheduler import Scheduler, SchedulerOutputs
from omniserve_tpu_torch.outputs import RequestOutput
from omniserve_tpu_torch.sampling_params import SamplingParams
from omniserve_tpu_torch.sequence import (
    SamplerOutput,
    Sequence,
    SequenceGroup,
    SequenceGroupMetadata,
    SequenceStatus,
)
from omniserve_tpu_torch.utils import Counter
from omniserve_tpu_torch.utils.logger import init_logger
from omniserve_tpu_torch.utils.tokenizer import (
    detokenize_incrementally,
    get_tokenizer,
)
from omniserve_tpu_torch.worker.worker import Worker

logger = init_logger(__name__)


class LLMEngine:
    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        parallel_config: ParallelConfig,
        scheduler_config: SchedulerConfig,
        device_config: DeviceConfig,
        ifb_config: IFBConfig,
        sp_attn_config: Optional[SpAttnConfig] = None,
        load_format: str = "auto",
        tokenizer_mode: str = "auto",
        tokenizer_path=None,
        tokenizer_revision: Optional[str] = None,
        revision: Optional[str] = None,
        download_dir: Optional[str] = None,
        benchmarking_mode: bool = False,
        omit_prompt: bool = False,
        log_stats: bool = False,
        log_requests: bool = True,
        max_log_len: Optional[int] = None,
    ) -> None:
        self.model_config = model_config
        self.cache_config = cache_config
        self.parallel_config = parallel_config
        self.scheduler_config = scheduler_config
        self.ifb_config = ifb_config
        self.sp_attn_config = sp_attn_config
        self.benchmarking_mode = benchmarking_mode
        self.omit_prompt = omit_prompt
        self.log_stats = log_stats
        self.log_requests = log_requests
        self.max_log_len = max_log_len
        self.seq_counter = Counter()

        self.tokenizer = None
        if tokenizer_mode != "skip":
            try:
                self.tokenizer = get_tokenizer(
                    tokenizer_path or model_config.model,
                    tokenizer_mode=tokenizer_mode,
                    revision=tokenizer_revision or revision,
                    download_dir=download_dir,
                )
            except Exception as e:  # dummy/benchmark models have no files
                logger.warning("tokenizer unavailable (%s); text decode off", e)

        self.worker = Worker(
            model_config, cache_config, scheduler_config,
            parallel_config=parallel_config, sp_attn_config=sp_attn_config,
            load_format=load_format, device=device_config.device,
        )
        self.worker.init_cache_engine()

        enable_streaming = bool(sp_attn_config and sp_attn_config.enable_streaming)
        self.scheduler = Scheduler(
            scheduler_config, cache_config, ifb_config,
            streaming_sink_blocks=(
                sp_attn_config.dec.sink_blocks if sp_attn_config else 0
            ),
            streaming_local_blocks=(
                sp_attn_config.dec.ring_local_blocks if sp_attn_config
                else 0
            ),
            enable_streaming=enable_streaming,
            sp_shards=(
                parallel_config.sequence_parallel_size
                if parallel_config else 1
            ),
        )

        # non-IFB static-batch state
        self._static_metadata: Optional[List[SequenceGroupMetadata]] = None
        self._static_outputs: Optional[SchedulerOutputs] = None
        self._multi_step_buffer: List = []
        self._inflight_window = None   # speculative pipelined window
        self._ifb_window_out: Optional[SchedulerOutputs] = None

        self.decoding_sim_length = int(
            os.environ.get("DECODING_SIMULATION_LENGTH", "0")
        )

        # periodic stats (reference accepts log_stats but never logs,
        # llm_engine.py:49,94 — here it is implemented: every
        # _LOG_STATS_INTERVAL s of step() activity, one line with prompt /
        # generation throughput, queue depths and KV-pool occupancy)
        self._last_stats_time = time.time()
        self._stats_prompt_tokens = 0
        self._stats_generation_tokens = 0

    # ------------------------------------------------------------------
    @classmethod
    def from_engine_args(cls, engine_args):
        if getattr(engine_args, "data_parallel_size", 1) > 1:
            raise NotImplementedError(
                "data-parallel replicas are ROADMAP.md queue 1 item 10"
            )
        configs = engine_args.create_engine_configs()
        return cls(**configs)

    # ------------------------------------------------------------------
    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        sampling_params: Optional[SamplingParams] = None,
        prompt_token_ids: Optional[List[int]] = None,
        arrival_time: Optional[float] = None,
        profiling_config: Optional[ProfilingConfig] = None,
        prefix_pos: Optional[int] = None,
    ) -> None:
        """``prefix_pos``: treat the first ``prefix_pos`` prompt tokens as
        a shared prefix — requests with an identical prefix reuse its KV
        pages (reference llm_engine.py:277-369; experimental there too)."""
        if sampling_params is None:
            sampling_params = SamplingParams()
        if arrival_time is None:
            arrival_time = time.monotonic()
        if profiling_config is not None:
            # fixed-shape random prompt (reference llm_engine.py:337-347)
            # stable digest: str hash is salted per process, which would
            # make profiling prompts non-reproducible across runs
            import zlib

            rng = np.random.default_rng(
                zlib.crc32(str(request_id).encode()) % (2**31)
            )
            prompt_token_ids = rng.integers(
                10, self.model_config.get_vocab_size() - 1,
                size=profiling_config.prompt_len,
            ).tolist()
            sampling_params.max_tokens = profiling_config.generate_len
            sampling_params.ignore_eos = True
        elif prompt_token_ids is None:
            if prompt is None:
                raise ValueError(
                    "add_request needs prompt or prompt_token_ids"
                )
            if self.tokenizer is None:
                raise RuntimeError(
                    "text prompts need a tokenizer, but none could be "
                    "loaded for this model; pass prompt_token_ids instead"
                )
            prompt_token_ids = self.tokenizer.encode(prompt)

        if self.decoding_sim_length > 0:
            sampling_params.decoding_sim_token_ids = prompt_token_ids[
                -self.decoding_sim_length:
            ]

        prefix = (
            self.scheduler.prefix_pool.add_or_get_prefix(
                prompt_token_ids[:prefix_pos]
            )
            if prefix_pos is not None
            else None
        )

        seqs = []
        for _ in range(sampling_params.best_of):
            seq = Sequence(
                next(self.seq_counter), prompt, prompt_token_ids,
                page_size=self.cache_config.page_size,
            )
            seqs.append(seq)
        group = SequenceGroup(
            request_id, seqs, sampling_params, arrival_time, prefix=prefix
        )
        self.scheduler.add_seq_group(group)

    def abort_request(self, request_id: Union[str, List[str]]) -> None:
        ids = [request_id] if isinstance(request_id, str) else request_id
        for seq_id in self.scheduler.abort_seq_group(ids):
            # scheduler free releases KV pages; the worker's persistent
            # decode slot must be released too or padded batch widths
            # grow for the life of the engine
            self.worker.free_seq(seq_id)

    def get_num_unfinished_requests(self) -> int:
        return self.scheduler.get_num_unfinished_seq_groups()

    def has_unfinished_requests(self) -> bool:
        return self.scheduler.has_unfinished_seqs()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        if self.ifb_config.ifb_mode:
            return self._step_ifb()
        return self._step_static()

    def _step_ifb(self) -> List[RequestOutput]:
        if self._multi_step_buffer:
            # drain a buffered IFB window (scheduling resumes when empty)
            return self._process_model_outputs(
                self._multi_step_buffer.pop(0), self._ifb_window_out
            )
        metadata, sched_out = self.scheduler.schedule()
        if sched_out.is_empty():
            return [
                RequestOutput.from_seq_group(g)
                for g in sched_out.ignored_seq_groups
            ]
        if self._ifb_can_multi_step(metadata, sched_out):
            n_multi = self.ifb_config.decode_multi_step
            for group in sched_out.scheduled_seq_groups:
                for seq in group.get_seqs(SequenceStatus.RUNNING):
                    self.scheduler.block_manager.reserve_slots(seq, n_multi)
            for meta, group in zip(metadata,
                                   sched_out.scheduled_seq_groups):
                for seq in group.get_seqs(SequenceStatus.RUNNING):
                    meta.block_tables[seq.seq_id] = (
                        self.scheduler.block_manager.get_block_table(seq)
                    )
                    if self.scheduler.block_manager.streaming is not None:
                        meta.streaming_block_tables[seq.seq_id] = (
                            self.scheduler.block_manager
                            .get_streaming_block_table(seq)
                        )
            outs = self.worker.execute_model_multi_step(metadata, n_multi)
            self._multi_step_buffer = outs[1:]
            self._ifb_window_out = sched_out
            return self._process_model_outputs(outs[0], sched_out)
        samples = self.worker.execute_model(
            metadata,
            sched_out.blocks_to_swap_in,
            sched_out.blocks_to_swap_out,
            sched_out.blocks_to_copy,
            sched_out.streaming_blocks_to_swap_in,
            sched_out.streaming_blocks_to_swap_out,
            sched_out.streaming_blocks_to_copy,
        )
        return self._process_model_outputs(samples, sched_out)

    def _ifb_can_multi_step(self, metadata, sched_out) -> bool:
        """An IFB iteration can run a whole greedy window when no
        scheduling decision could change inside it: a pure decode batch,
        no pending admissions/swaps, everything greedy, and pool headroom
        for the window (mid-window finishes just discard their tail)."""
        n_multi = self.ifb_config.decode_multi_step
        if n_multi <= 1 or not self.worker.multi_step_capable:
            return False
        if any(m.is_prompt for m in metadata):
            return False
        if (
            sched_out.blocks_to_swap_in or sched_out.blocks_to_swap_out
            or sched_out.blocks_to_copy
            or sched_out.streaming_blocks_to_swap_in
            or sched_out.streaming_blocks_to_swap_out
            or sched_out.streaming_blocks_to_copy
        ):
            return False
        if self.scheduler.waiting or self.scheduler.swapped:
            return False
        groups = sched_out.scheduled_seq_groups
        if not all(
            g.sampling_params.temperature < 1e-5 for g in groups
        ):
            return False
        if any(g.sampling_params.decoding_sim_token_ids for g in groups):
            # inside a window the device feeds its own argmax tokens; the
            # forced simulation tokens would only resync at boundaries
            return False
        seqs = [
            seq for g in groups
            for seq in g.get_seqs(SequenceStatus.RUNNING)
        ]
        return self.scheduler.block_manager.can_reserve_slots(
            seqs, self.ifb_config.decode_multi_step
        )

    def _step_static(self) -> List[RequestOutput]:
        """Non-IFB: schedule once, then reuse the static batch
        (reference llm_engine.py:562-592). With
        ``ifb_config.decode_multi_step > 1`` decode advances several tokens
        per worker call in one window; subsequent step() calls drain the
        buffered per-token outputs."""
        if self._static_metadata is not None:
            groups = self._static_outputs.scheduled_seq_groups
            if all(g.is_finished() for g in groups):
                # whole static batch done: reset so the next step schedules
                # the next batch of requests
                self._static_metadata = None
                self._static_outputs = None
                self._multi_step_buffer.clear()
                self._inflight_window = None
            elif not self._multi_step_buffer:
                # Drop finished groups ONLY between multi-step windows: the
                # buffered SamplerOutputs are positional in the group list
                # that produced them, so the list must stay frozen while a
                # window drains (finished seqs are skipped when zipping).
                live = [
                    (m, g) for m, g in zip(self._static_metadata, groups)
                    if not g.is_finished()
                ]
                if len(live) != len(self._static_metadata):
                    self._static_metadata = [m for m, _ in live]
                    self._static_outputs.scheduled_seq_groups = [
                        g for _, g in live
                    ]
        if self._static_metadata is None:
            self._multi_step_buffer.clear()   # new static batch
            self._inflight_window = None
        if self._multi_step_buffer:
            # Drain step: pure host bookkeeping. Block tables are only read
            # at the next execute-model call (the window start grows and
            # refreshes them), so no per-drain table maintenance.
            samples = self._multi_step_buffer.pop(0)
            return self._process_model_outputs(
                samples, self._static_outputs,
                check_stop=not self.benchmarking_mode,
            )
        n_multi = max(1, self.ifb_config.decode_multi_step)
        copy, s_copy = {}, {}
        if self._static_metadata is None:
            self._static_metadata, self._static_outputs = (
                self.scheduler.schedule()
            )
        else:
            for meta in self._static_metadata:
                meta.is_prompt = False
            copy, s_copy = self._grow_static_tables()
            groups = self._static_outputs.scheduled_seq_groups
            running = [
                seq for g in groups
                for seq in g.get_seqs(SequenceStatus.RUNNING)
            ]
            no_sim = not any(
                g.sampling_params.decoding_sim_token_ids for g in groups
            )
            if (
                n_multi > 1
                and self._all_greedy()
                and no_sim
                and self.worker.multi_step_capable
                and self.scheduler.block_manager.can_reserve_slots(
                    running, n_multi
                )
            ):
                # Pipelined windows: if a window is already in flight
                # (launched speculatively at the previous boundary), launch
                # the NEXT one before fetching its tokens, so the device
                # never idles on the host's token sync + window prep.
                # Speculation needs unshared pages (no forks/prefix): a
                # copy-on-write decision made from host state would be one
                # window stale against the in-flight device writes.
                speculate = self.benchmarking_mode and all(
                    g.get_max_num_running_seqs() == 1
                    and getattr(g, "prefix", None) is None
                    for g in groups
                ) and all(
                    seq.get_output_len() + 2 * n_multi
                    <= g.sampling_params.max_tokens
                    for g in groups
                    for seq in g.get_seqs(SequenceStatus.RUNNING)
                )
                horizon = n_multi * (2 if speculate else 1)
                if speculate and not (
                    self.scheduler.block_manager.can_reserve_slots(
                        running, horizon
                    )
                ):
                    speculate = False
                    horizon = n_multi
                for seq in running:
                    self.scheduler.block_manager.reserve_slots(
                        seq, horizon
                    )
                self._refresh_static_tables()
                if copy or s_copy:
                    # apply copy-on-writes before the window launches (no
                    # window can be in flight here: speculation is gated
                    # off for shared pages, the only CoW source)
                    assert self._inflight_window is None
                    self.worker.execute_model(
                        [], {}, {}, copy, {}, {}, s_copy
                    )
                handle = self._inflight_window
                self._inflight_window = None
                if handle is None:
                    handle = self.worker.start_multi_step(
                        self._static_metadata, n_multi
                    )
                if speculate:
                    # host seq state is one window behind the device here:
                    # offset positions by the in-flight window and seed
                    # token ids from its device output
                    self._inflight_window = self.worker.start_multi_step(
                        self._static_metadata, n_multi,
                        pos_offset=n_multi,
                        carry_tokens=self.worker.multi_step_carry(handle),
                    )
                outs = self.worker.finish_multi_step(handle)
                self._multi_step_buffer = outs[1:]
                return self._process_model_outputs(
                    outs[0], self._static_outputs,
                    check_stop=not self.benchmarking_mode,
                )
        samples = self.worker.execute_model(
            self._static_metadata, {}, {}, copy, {}, {}, s_copy
        )
        return self._process_model_outputs(
            samples, self._static_outputs, check_stop=not self.benchmarking_mode
        )

    def _all_greedy(self) -> bool:
        return all(
            g.sampling_params.temperature < 1e-5
            for g in self._static_outputs.scheduled_seq_groups
        )

    def _refresh_static_tables(self) -> None:
        for meta, group in zip(
            self._static_metadata,
            self._static_outputs.scheduled_seq_groups,
        ):
            for seq in group.get_seqs(SequenceStatus.RUNNING):
                meta.block_tables[seq.seq_id] = (
                    self.scheduler.block_manager.get_block_table(seq)
                )
                if self.scheduler.block_manager.streaming is not None:
                    meta.streaming_block_tables[seq.seq_id] = (
                        self.scheduler.block_manager
                        .get_streaming_block_table(seq)
                    )

    def _grow_static_tables(self):
        """Account one appended token per running seq; returns the
        (retrieval, streaming) copy-on-write maps append_slot produced —
        dropping them would leave forked/prefix-shared sequences pointing
        at never-copied pages (silent garbage KV)."""
        copy, s_copy = {}, {}
        for meta, group in zip(
            self._static_metadata,
            self._static_outputs.scheduled_seq_groups,
        ):
            for seq in group.get_seqs(SequenceStatus.RUNNING):
                r_cow, s_cow = self.scheduler.block_manager.append_slot(seq)
                if r_cow is not None:
                    copy.setdefault(r_cow[0], []).append(r_cow[1])
                if s_cow is not None:
                    s_copy.setdefault(s_cow[0], []).append(s_cow[1])
        self._refresh_static_tables()
        return copy, s_copy

    # ------------------------------------------------------------------
    _LOG_STATS_INTERVAL = 5.0   # seconds (reference's unused constant, made real)

    def _maybe_log_stats(self) -> None:
        now = time.time()
        elapsed = now - self._last_stats_time
        if elapsed < self._LOG_STATS_INTERVAL:
            return
        bm = self.scheduler.block_manager
        total_r = self.cache_config.num_retrieval_device_blocks
        used_r = total_r - bm.get_num_free_device_blocks()
        kv_pct = 100.0 * used_r / max(total_r, 1)
        stream = ""
        if bm.streaming is not None:
            total_s = self.cache_config.num_streaming_device_blocks
            used_s = total_s - bm.streaming.get_num_free_device_blocks()
            stream = f", streaming KV {100.0 * used_s / max(total_s, 1):.1f}%"
        logger.info(
            "throughput: %.1f prompt tok/s, %.1f generation tok/s | "
            "running %d, swapped %d, waiting %d | KV pool %.1f%%%s",
            self._stats_prompt_tokens / elapsed,
            self._stats_generation_tokens / elapsed,
            len(self.scheduler.running),
            len(self.scheduler.swapped),
            len(self.scheduler.waiting),
            kv_pct,
            stream,
        )
        self._last_stats_time = now
        self._stats_prompt_tokens = 0
        self._stats_generation_tokens = 0

    def _process_model_outputs(
        self,
        samples: SamplerOutput,
        sched_out: SchedulerOutputs,
        check_stop: bool = True,
    ) -> List[RequestOutput]:
        groups = sched_out.scheduled_seq_groups
        if sched_out.prompt_run:
            if self.log_stats:
                self._stats_prompt_tokens += sched_out.num_batched_tokens
            for g in groups:
                # the prefill that just ran wrote this prefix's KV pages:
                # later requests sharing it prefill only their suffix
                # (reference prefix.py:53-91 allocates but never computes)
                p = getattr(g, "prefix", None)
                if p is not None and p.allocated and not p.evicted:
                    p.computed = True
        for group, group_out in zip(groups, samples):
            for sample in group_out.samples:
                seq = group.find(sample.parent_seq_id)
                if seq.is_finished():
                    continue
                if self.log_stats:
                    self._stats_generation_tokens += 1
                token = sample.output_token
                sp = group.sampling_params
                if sp.decoding_sim_token_ids:
                    token = sp.decoding_sim_token_ids[
                        min(
                            seq.get_output_len(),
                            len(sp.decoding_sim_token_ids) - 1,
                        )
                    ]
                seq.append_token_id(
                    token, getattr(sample, "logprob", 0.0)
                )
                if self.tokenizer is not None and check_stop:
                    new_text, seq.prefix_offset, seq.read_offset = (
                        detokenize_incrementally(
                            self.tokenizer,
                            seq.data.output_token_ids,
                            seq.prefix_offset,
                            seq.read_offset,
                            sp.skip_special_tokens,
                        )
                    )
                    seq.output_text += new_text
                if check_stop:
                    self._check_stop(seq, sp)
                elif seq.get_output_len() >= sp.max_tokens:
                    # benchmarking mode skips text stop checks but must
                    # still finish at max_tokens (fixed-length generation,
                    # reference llm_engine.py:484-592)
                    seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
                if seq.is_finished():
                    self.scheduler.free_seq(seq)
                    self.worker.free_seq(seq.seq_id)
        self.scheduler.free_finished_seq_groups()
        if self.log_stats:
            self._maybe_log_stats()
        if self.benchmarking_mode:
            # benchmark drivers ignore per-step outputs (reference
            # _process_model_outputs_benchmark, llm_engine.py:467-479);
            # building 128 RequestOutputs/step is pure host overhead
            return []
        outputs = [RequestOutput.from_seq_group(g) for g in groups]
        outputs.extend(
            RequestOutput.from_seq_group(g)
            for g in sched_out.ignored_seq_groups
        )
        if self.omit_prompt:
            # reference --omit-prompt (arg_utils.py:363-367): strip the
            # prompt from user-facing outputs
            for o in outputs:
                o.prompt = None
                o.prompt_token_ids = []
        return outputs

    def _check_stop(self, seq: Sequence, sp: SamplingParams) -> None:
        for stop_str in sp.stop:
            if stop_str and seq.output_text.endswith(stop_str):
                seq.output_text = seq.output_text[: -len(stop_str)]
                seq.status = SequenceStatus.FINISHED_STOPPED
                seq.stop_reason = stop_str
                return
        last = seq.get_last_token_id()
        if last in sp.stop_token_ids:
            seq.status = SequenceStatus.FINISHED_STOPPED
            return
        if (
            not sp.ignore_eos
            and self.tokenizer is not None
            and last == self.tokenizer.eos_token_id
        ):
            seq.status = SequenceStatus.FINISHED_STOPPED
            return
        if seq.get_output_len() >= sp.max_tokens:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
            return
        if seq.get_len() >= self.scheduler_config.max_model_len:
            seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
