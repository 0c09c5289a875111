"""EngineArgs: CLI flag surface -> engine config objects.

Port of ``omniserve_tpu.engine.arg_utils`` (same flags). Differences: the
engine serves on ``cuda:0`` unless ``device="cpu"`` is asked for, and it
raises when CUDA is absent instead of choosing another device;
``tokenizer_mode="skip"`` serves without a tokenizer.

Mirrors the reference ``omniserve/engine/arg_utils.py`` flag set so the
benchmark/eval scripts port over unchanged, including precision parsing
(w4a8kv4 etc. -> kv bits/zeros, reference arg_utils.py:481-510) and the
env-var pool sizing (NUM_RETRIEVAL_GPU_PAGE_BLOCKS /
NUM_STREAMING_GPU_PAGE_BLOCKS, reference model_runner.py:229-239, with the
25 x batch heuristic from README.md:281 as fallback).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

from omniserve_tpu_torch.attn_config import SpAttnConfig, sparse_attn_init
from omniserve_tpu_torch.config import (
    CacheConfig,
    DeviceConfig,
    IFBConfig,
    ModelConfig,
    ParallelConfig,
    SchedulerConfig,
)
from omniserve_tpu_torch.utils.constants import PAGE_SIZE


def resolve_device(device: str) -> str:
    """"auto"/"cuda" -> "cuda:0" (raises without CUDA); "cpu" stays."""
    if device == "cpu":
        return "cpu"
    if device in ("auto", "cuda"):
        device = "cuda:0"
    if not device.startswith("cuda"):
        raise ValueError(f"device must be auto, cuda[:N] or cpu, got {device}")
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port serves on an NVIDIA GPU; pass "
            "device='cpu' to run the plain PyTorch versions instead"
        )
    return device


@dataclasses.dataclass
class EngineArgs:
    model: str
    tokenizer: Optional[str] = None
    tokenizer_mode: str = "auto"
    precision: str = "w16a16kv16"
    quant_path: Optional[str] = None
    group_size: int = -1
    kv_quant_granularity: str = "fine_grained"
    # fp16 = reference parity; w8a8 halves the decode lm_head read
    lm_head_precision: str = "fp16"
    load_format: str = "auto"
    trust_remote_code: bool = True
    max_model_len: Optional[int] = None
    seed: int = 0
    # reference kv-cache overrides (arg_utils.py:192-200, config.py): these
    # rewrite the kv part of --precision so reference launch scripts that
    # spell kv settings separately run unmodified
    dtype: str = "auto"
    kv_cache_dtype: Optional[str] = None
    int4_kv: bool = False
    kv_zp: bool = False
    quantization: Optional[str] = None
    # HF loading knobs (reference arg_utils.py:153-181)
    revision: Optional[str] = None
    code_revision: Optional[str] = None
    tokenizer_revision: Optional[str] = None
    download_dir: Optional[str] = None
    max_parallel_loading_workers: Optional[int] = None
    # logging (reference arg_utils.py:275-280 + AsyncEngineArgs)
    disable_log_stats: bool = False
    disable_log_requests: bool = False
    max_log_len: Optional[int] = None
    # "auto" and "cuda" serve on cuda:0; "cpu" only when asked for. The
    # CUDA-graph and all-reduce knobs are accepted for CLI parity.
    device: str = "auto"
    enforce_eager: bool = False
    max_context_len_to_capture: int = 8192
    disable_custom_all_reduce: bool = False
    max_paddings: int = 256
    # parallel
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    sequence_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    device_offset: int = 0  # set by DataParallelEngine per replica
    # memory
    block_size: int = PAGE_SIZE
    gpu_memory_utilization: float = 0.9
    swap_space: float = 4.0
    num_retrieval_blocks: Optional[int] = None
    num_streaming_blocks: Optional[int] = None
    # scheduler
    max_num_batched_tokens: int = 262144
    max_num_seqs: int = 256
    chunk_prefill_size: int = 32000
    ifb_mode: bool = True
    decode_multi_step: int = 1
    benchmarking_mode: bool = False
    omit_prompt: bool = False
    # sparse attention (LServe)
    sparse_context_mode: bool = False
    sparse_decode_mode: bool = False
    static_sparsity: float = 0.0
    attn_pattern_path: Optional[str] = None
    ctx_sink_size: int = 128
    ctx_local_size: int = 8192
    dec_sink_size: int = 128
    dec_local_size: int = 256
    sub_chunk_per_block: int = 4
    sparse_kv_cache_budget: int = 4096
    selector_update_interval: int = 4
    multiblock_switch: int = 2048

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser.add_argument("--model", type=str, required=True)
        parser.add_argument("--tokenizer", type=str, default=None)
        parser.add_argument("--tokenizer-mode", type=str, default="auto",
                            choices=["auto", "slow", "skip"],
                            help='"auto" uses the fast tokenizer when '
                                 'available, "slow" always the slow one, '
                                 '"skip" serves token ids without one')
        parser.add_argument("--revision", type=str, default=None,
                            help="HF revision of the model weights/config")
        parser.add_argument("--code-revision", type=str, default=None,
                            help="HF revision for remote model code")
        parser.add_argument("--tokenizer-revision", type=str, default=None)
        parser.add_argument("--download-dir", type=str, default=None,
                            help="HF cache directory for downloads")
        parser.add_argument("--max-parallel-loading-workers", type=int,
                            default=None,
                            help="accepted for reference-CLI parity; the "
                                 "loader streams tensors sequentially")
        parser.add_argument("--dtype", type=str, default="auto",
                            choices=["auto", "half", "float16", "bfloat16",
                                     "float", "float32"],
                            help="activation dtype; fp16 spellings map to "
                                 "bfloat16")
        parser.add_argument("--kv-cache-dtype", type=str, default=None,
                            choices=["int8", "int4", "fp16", "auto"],
                            help="overrides the kv part of --precision "
                                 "(fp16 -> kv16 bf16 storage)")
        parser.add_argument("--int4-kv", action="store_true",
                            help="4-bit KV cache (same as kv4 precision)")
        parser.add_argument("--kv-zp", action="store_true",
                            help="zero-point (fine-grained) KV quant")
        parser.add_argument("--quantization", "-q", type=str, default=None,
                            choices=["awq", "gptq", "squeezellm"],
                            help="reference weight-quant methods; the "
                                 "runtime serves QoQ checkpoints — convert "
                                 "with omniserve_tpu_torch.ckpt_converter "
                                 "first")
        parser.add_argument("--disable-log-stats", action="store_true",
                            help="disable periodic engine stats logging")
        parser.add_argument("--disable-log-requests", action="store_true")
        parser.add_argument("--max-log-len", type=int, default=None,
                            help="truncate logged prompts to this length")
        parser.add_argument("--device", type=str, default="auto",
                            choices=["auto", "cuda", "cpu"],
                            help='"auto"/"cuda" serve on cuda:0 (and fail '
                                 'without CUDA); "cpu" runs the plain '
                                 "PyTorch versions of the kernels")
        parser.add_argument("--enforce-eager", action="store_true",
                            help="accepted for CLI parity (on a card, "
                                 "decode windows always replay a captured "
                                 "CUDA graph)")
        parser.add_argument("--max-context-len-to-capture", type=int,
                            default=8192,
                            help="accepted for CLI parity (CUDA-graph "
                                 "capture bound)")
        parser.add_argument("--disable-custom-all-reduce",
                            action="store_true",
                            help="accepted for CLI parity (one device)")
        parser.add_argument("--max-paddings", type=int, default=256,
                            help="max padding tokens admitted into one "
                                 "prefill batch")
        parser.add_argument("--lm-head-precision", type=str,
                            default="fp16", choices=["fp16", "w8a8"],
                            help="lm_head GEMM precision (fp16 = reference "
                                 "parity; w8a8 halves the decode head read)")
        parser.add_argument("--precision", type=str, default="w16a16kv16",
                            help="e.g. w4a8kv4, w4a8kv8, w8a8kv8, w16a16kv8")
        parser.add_argument("--quant-path", type=str, default=None)
        parser.add_argument("--group-size", type=int, default=-1,
                            help="-1 per-channel, 128 per-group")
        parser.add_argument("--kv-quant-granularity", type=str,
                            default="fine_grained",
                            choices=["fine_grained", "per_tensor"])
        parser.add_argument("--load-format", type=str, default="auto",
                            choices=["auto", "dummy"])
        parser.add_argument("--max-model-len", type=int, default=None)
        parser.add_argument("--seed", type=int, default=0)
        parser.add_argument("-tp", "--tensor-parallel-size", type=int,
                            default=1)
        parser.add_argument("-dp", "--data-parallel-size", type=int,
                            default=1)
        parser.add_argument("-sp", "--sequence-parallel-size", type=int,
                            default=1)
        parser.add_argument("-pp", "--pipeline-parallel-size", type=int,
                            default=1)
        parser.add_argument("--block-size", type=int, default=PAGE_SIZE)
        parser.add_argument("--gpu-memory-utilization", type=float,
                            default=0.9)
        parser.add_argument("--swap-space", type=float, default=4.0)
        parser.add_argument("--num-retrieval-blocks", type=int, default=None)
        parser.add_argument("--num-streaming-blocks", type=int, default=None)
        parser.add_argument("--max-num-batched-tokens", type=int,
                            default=262144)
        parser.add_argument("--max-num-seqs", type=int, default=256)
        parser.add_argument("--chunk-prefill-size", type=int, default=32000)
        parser.add_argument("--ifb-mode", action="store_true", default=True)
        parser.add_argument("--decode-multi-step", type=int, default=1,
                            help="non-IFB greedy decode tokens per engine "
                                 "step (the port runs 1)")
        parser.add_argument("--no-ifb-mode", dest="ifb_mode",
                            action="store_false")
        parser.add_argument("--benchmarking-mode", "--benchmarking",
                            action="store_true", default=False)
        parser.add_argument("--sparse-context-mode", action="store_true")
        parser.add_argument("--sparse-decode-mode", action="store_true")
        parser.add_argument("--static-sparsity", type=float, default=0.0)
        # second names = the reference's flag spellings
        # (arg_utils.py:331-440), kept as aliases so its launch scripts run
        parser.add_argument("--attn-pattern-path",
                            "--static-sparse-attn-load-dir",
                            type=str, default=None)
        parser.add_argument("--ctx-sink-size", "--ctx-sink-token",
                            type=int, default=128)
        parser.add_argument("--ctx-local-size", "--ctx-local-token",
                            type=int, default=8192)
        parser.add_argument("--dec-sink-size", "--dec-sink-token",
                            type=int, default=128)
        parser.add_argument("--dec-local-size", "--dec-local-token",
                            type=int, default=256)
        parser.add_argument("--sub-chunk-per-block", type=int, default=4)
        parser.add_argument("--sparse-kv-cache-budget",
                            "--dynamic-sparse-token-budget", type=int,
                            default=4096)
        parser.add_argument("--omit-prompt", action="store_true",
                            help="omit the prompt text in final outputs")
        parser.add_argument("--trust-remote-code", action="store_true",
                            default=True)
        parser.add_argument("--selector-update-interval", type=int, default=4)
        parser.add_argument(
            "--multiblock-switch", type=int, default=2048,
            help="accepted for reference-CLI parity; a NO-OP in the port, as "
            "in the JAX package (its decode kernels split every page list "
            "over blocks by a plan from the batch's shapes alone)",
        )
        return parser

    @classmethod
    def from_cli_args(cls, args: argparse.Namespace) -> "EngineArgs":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(args).items() if k in fields})

    def _effective_precision_and_granularity(self):
        """Fold the reference's separate kv flags into the precision string.

        ``--kv-cache-dtype`` / ``--int4-kv`` / ``--kv-zp`` override the kv
        part of ``--precision`` (reference config.py builds its kv cache
        config from exactly these three)."""
        precision = self.precision
        granularity = self.kv_quant_granularity
        kv_bits = None
        if self.kv_cache_dtype not in (None, "auto"):
            kv_bits = {"int8": 8, "int4": 4, "fp16": 16}[self.kv_cache_dtype]
        if self.int4_kv:
            kv_bits = 4
        if kv_bits is not None:
            import re

            precision = re.sub(r"kv\d+$", f"kv{kv_bits}", precision)
            if not precision.endswith(f"kv{kv_bits}"):
                precision = f"{precision}kv{kv_bits}"
        if self.kv_zp:
            granularity = "fine_grained"
        return precision, granularity

    @staticmethod
    def _map_dtype(dtype: str) -> str:
        if dtype in ("auto", "half", "float16", "bfloat16"):
            # fp16 spellings map to bf16 (the JAX package's choice); bf16
            # shares fp32's exponent so no loss-scale is needed
            return "bfloat16"
        return "float32"

    def create_engine_configs(self) -> dict:
        precision, granularity = self._effective_precision_and_granularity()
        if self.quantization is not None:
            raise ValueError(
                f"--quantization {self.quantization} checkpoints are not "
                "served directly; pack a QoQ dump with python -m "
                "omniserve_tpu_torch.ckpt_converter.convert and pass "
                "--quant-path"
            )
        model_config = ModelConfig(
            model=self.model,
            precision=precision,
            quant_path=self.quant_path,
            max_model_len=self.max_model_len,
            group_size=self.group_size,
            kv_quant_granularity=granularity,
            dtype=self._map_dtype(self.dtype),
            seed=self.seed,
            trust_remote_code=self.trust_remote_code,
            revision=self.revision,
            code_revision=self.code_revision,
            download_dir=self.download_dir,
            lm_head_precision=self.lm_head_precision,
        )
        sp_attn_config: Optional[SpAttnConfig] = None
        if self.sparse_context_mode or self.sparse_decode_mode:
            sp_attn_config = sparse_attn_init(
                sparse_context_mode=self.sparse_context_mode,
                sparse_decode_mode=self.sparse_decode_mode,
                static_sparsity=self.static_sparsity,
                attn_pattern_path=self.attn_pattern_path,
                ctx_sink_size=self.ctx_sink_size,
                ctx_local_size=self.ctx_local_size,
                dec_sink_size=self.dec_sink_size,
                dec_local_size=self.dec_local_size,
                sub_chunk_per_block=self.sub_chunk_per_block,
                sparse_kv_cache_budget=self.sparse_kv_cache_budget,
                selector_update_interval=self.selector_update_interval,
                multiblock_switch=self.multiblock_switch,
                page_size=self.block_size,
                num_layers=model_config.get_num_layers(),
                num_kv_heads=model_config.get_num_kv_heads(),
                chunk_prefill_size=self.chunk_prefill_size,
                max_model_len=model_config.max_model_len,
            )

        n_retr = self.num_retrieval_blocks
        if n_retr is None:
            n_retr = int(
                os.environ.get(
                    "NUM_RETRIEVAL_GPU_PAGE_BLOCKS", 25 * self.max_num_seqs
                )
            )
        n_stream = self.num_streaming_blocks
        if n_stream is None:
            if sp_attn_config and sp_attn_config.enable_streaming:
                ring = (
                    sp_attn_config.dec.sink_blocks
                    + sp_attn_config.dec.ring_local_blocks
                ) * self.max_num_seqs
                # headroom must exceed the allocation watermark (1%)
                default_stream = ring + max(4, ring // 50)
            else:
                default_stream = 0
            n_stream = int(
                os.environ.get(
                    "NUM_STREAMING_GPU_PAGE_BLOCKS", default_stream
                )
            )
        swap_blocks = max(n_retr // 2, 1)
        cache_config = CacheConfig(
            page_size=self.block_size,
            num_retrieval_device_blocks=n_retr,
            num_retrieval_cpu_blocks=swap_blocks,
            num_streaming_device_blocks=n_stream,
            num_streaming_cpu_blocks=max(n_stream // 2, 1),
            memory_utilization=self.gpu_memory_utilization,
            swap_space_gb=self.swap_space,
        )
        parallel_config = ParallelConfig(
            tensor_parallel_size=self.tensor_parallel_size,
            data_parallel_size=self.data_parallel_size,
            sequence_parallel_size=self.sequence_parallel_size,
            pipeline_parallel_size=self.pipeline_parallel_size,
            device_offset=self.device_offset,
        )
        scheduler_config = SchedulerConfig(
            max_num_batched_tokens=self.max_num_batched_tokens,
            max_num_seqs=self.max_num_seqs,
            max_model_len=model_config.max_model_len,
            chunk_prefill_size=self.chunk_prefill_size,
            max_paddings=self.max_paddings,
        )
        device = resolve_device(self.device)
        return dict(
            model_config=model_config,
            cache_config=cache_config,
            parallel_config=parallel_config,
            scheduler_config=scheduler_config,
            device_config=DeviceConfig(device=device),
            ifb_config=IFBConfig(ifb_mode=self.ifb_mode,
                                 decode_multi_step=self.decode_multi_step),
            sp_attn_config=sp_attn_config,
            load_format=self.load_format,
            tokenizer_path=self.tokenizer,
            tokenizer_mode=self.tokenizer_mode,
            tokenizer_revision=self.tokenizer_revision,
            revision=self.revision,
            download_dir=self.download_dir,
            benchmarking_mode=self.benchmarking_mode,
            omit_prompt=self.omit_prompt,
            log_stats=not self.disable_log_stats,
            log_requests=not self.disable_log_requests,
            max_log_len=self.max_log_len,
        )
