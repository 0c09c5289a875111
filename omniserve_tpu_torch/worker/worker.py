"""Worker: owns a ModelRunner + CacheEngine, executes scheduler output.

Counterpart of ``omniserve_tpu.worker.worker`` on one device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from omniserve_tpu_torch.config import (
    CacheConfig,
    ModelConfig,
    ParallelConfig,
    SchedulerConfig,
)
from omniserve_tpu_torch.sequence import SamplerOutput, SequenceGroupMetadata
from omniserve_tpu_torch.worker.model_runner import ModelRunner


class Worker:
    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        scheduler_config: SchedulerConfig,
        parallel_config: Optional[ParallelConfig] = None,
        sp_attn_config=None,
        load_format: str = "auto",
        rank: int = 0,
        device="cuda:0",
    ) -> None:
        self.rank = rank
        self.model_runner: Optional[ModelRunner] = None
        self._configs = (
            model_config, cache_config, scheduler_config, parallel_config,
            sp_attn_config, load_format, device,
        )

    def init_cache_engine(self) -> None:
        (model_config, cache_config, scheduler_config, parallel_config,
         sp_attn_config, load_format, device) = self._configs
        self.model_runner = ModelRunner(
            model_config, cache_config, scheduler_config,
            parallel_config=parallel_config, sp_attn_config=sp_attn_config,
            load_format=load_format, device=device,
        )

    def execute_model_multi_step(self, seq_group_metadata_list, n_steps):
        return self.model_runner.execute_model_multi_step(
            seq_group_metadata_list, n_steps
        )

    def start_multi_step(self, seq_group_metadata_list, n_steps,
                         pos_offset=0, carry_tokens=None):
        return self.model_runner.start_multi_step(
            seq_group_metadata_list, n_steps, pos_offset=pos_offset,
            carry_tokens=carry_tokens,
        )

    def finish_multi_step(self, handle):
        return self.model_runner.finish_multi_step(handle)

    def multi_step_carry(self, handle):
        return self.model_runner.multi_step_carry(handle)

    @property
    def multi_step_capable(self) -> bool:
        return (self.model_runner is not None
                and self.model_runner.multi_step_capable)

    def execute_model(
        self,
        seq_group_metadata_list: List[SequenceGroupMetadata],
        blocks_to_swap_in: Dict[int, int],
        blocks_to_swap_out: Dict[int, int],
        blocks_to_copy: Dict[int, List[int]],
        streaming_blocks_to_swap_in: Optional[Dict[int, int]] = None,
        streaming_blocks_to_swap_out: Optional[Dict[int, int]] = None,
        streaming_blocks_to_copy: Optional[Dict[int, List[int]]] = None,
    ) -> SamplerOutput:
        ce = self.model_runner.cache_engine
        ce.swap_out(blocks_to_swap_out, streaming=False)
        ce.swap_out(streaming_blocks_to_swap_out, streaming=True)
        ce.swap_in(blocks_to_swap_in, streaming=False)
        ce.swap_in(streaming_blocks_to_swap_in, streaming=True)
        ce.copy_pages(blocks_to_copy, streaming=False)
        ce.copy_pages(streaming_blocks_to_copy, streaming=True)
        if not seq_group_metadata_list:
            return []
        return self.model_runner.execute_model(seq_group_metadata_list)

    def free_seq(self, seq_id: int) -> None:
        if self.model_runner is not None:
            self.model_runner.free_seq(seq_id)
