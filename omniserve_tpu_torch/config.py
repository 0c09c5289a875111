"""Engine configuration objects.

Same roles and fields as ``omniserve_tpu.config`` (ModelConfig wrapping the
HF config, CacheConfig with the four pool sizes, ParallelConfig,
SchedulerConfig, DeviceConfig, IFBConfig, ProfilingConfig). The port serves
on one device; parallel sizes above 1 are refused by the model runner.
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
from typing import Any, Optional

from omniserve_tpu_torch.utils.constants import MAX_SEQ_LEN, PAGE_SIZE


def parse_precision(precision: str) -> dict:
    """Parse a precision string like 'w4a8kv4' into quant knobs.

    Mirrors the reference's parsing (engine/arg_utils.py:481-510):
    - weight bits: 4|8|16, activation bits: 8|16, kv bits: 4|8|16
    - kv defaults to activation bits when not given.
    """
    p = precision.lower()
    if not p.startswith("w"):
        raise ValueError(f"Bad precision string: {precision}")
    try:
        w_part, rest = p[1:].split("a", 1)
        if "kv" in rest:
            a_part, kv_part = rest.split("kv", 1)
        else:
            a_part, kv_part = rest, rest
        w_bits, a_bits, kv_bits = int(w_part), int(a_part), int(kv_part)
    except Exception as e:
        raise ValueError(f"Bad precision string: {precision}") from e
    if w_bits not in (4, 8, 16):
        raise ValueError(f"weight bits must be 4/8/16, got {w_bits}")
    if a_bits not in (8, 16):
        raise ValueError(f"activation bits must be 8/16, got {a_bits}")
    if kv_bits not in (4, 8, 16):
        raise ValueError(f"kv bits must be 4/8/16, got {kv_bits}")
    return {"weight_bits": w_bits, "act_bits": a_bits, "kv_bits": kv_bits}


def load_hf_config(model: str) -> types.SimpleNamespace:
    """Read a HF-style ``config.json`` from a model directory.

    Only local directories are served (there is no hub download): the
    attributes are the JSON keys, as ``transformers.AutoConfig`` exposes
    them for the Llama family.
    """
    path = os.path.join(model, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found: pass a local model directory holding a "
            "HF config.json"
        )
    with open(path) as f:
        return types.SimpleNamespace(**json.load(f))


class ModelConfig:
    """Model + quantization configuration.

    ``hf_config`` may be passed directly (tests, synthetic models) or read
    from ``<model>/config.json`` into a namespace (``load_hf_config``); the
    port does not need ``transformers``.
    """

    def __init__(
        self,
        model: str,
        precision: str = "w16a16kv16",
        hf_config: Optional[Any] = None,
        quant_path: Optional[str] = None,
        max_model_len: Optional[int] = None,
        group_size: int = -1,
        kv_quant_granularity: str = "fine_grained",
        dtype: str = "bfloat16",
        seed: int = 0,
        trust_remote_code: bool = True,
        revision: Optional[str] = None,
        code_revision: Optional[str] = None,
        download_dir: Optional[str] = None,
        lm_head_precision: str = "fp16",
    ) -> None:
        self.model = model
        self.precision = precision
        self.quant_path = quant_path
        self.group_size = group_size
        self.dtype = dtype
        self.seed = seed
        bits = parse_precision(precision)
        self.weight_bits = bits["weight_bits"]
        self.act_bits = bits["act_bits"]
        self.kv_cache_bits = bits["kv_bits"]
        self.int4_kv = self.kv_cache_bits == 4
        # fine_grained -> per-token-per-head asymmetric quant with zero points;
        # per_tensor -> calibrated per-layer scales, no zero points
        # (reference arg_utils.py:502-507).
        if kv_quant_granularity not in ("fine_grained", "per_tensor"):
            raise ValueError(
                f"kv_quant_granularity must be fine_grained|per_tensor, "
                f"got {kv_quant_granularity}"
            )
        self.kv_quant_granularity = kv_quant_granularity
        self.kv_zeros = kv_quant_granularity == "fine_grained"
        # fp16 (reference parity: the CUDA build keeps the head fp16) or
        # w8a8 (per-channel int8 head; halves the decode head read)
        if lm_head_precision not in ("fp16", "w8a8"):
            raise ValueError(
                f"lm_head_precision must be fp16|w8a8, got "
                f"{lm_head_precision}"
            )
        self.lm_head_precision = lm_head_precision
        self.lm_head_bits = 8 if lm_head_precision == "w8a8" else 16

        self.revision = revision
        self.code_revision = code_revision
        self.download_dir = download_dir
        if hf_config is None:
            hf_config = load_hf_config(model)
        self.hf_config = hf_config
        derived_max = getattr(hf_config, "max_position_embeddings", MAX_SEQ_LEN)
        if max_model_len is not None:
            # explicit user setting wins (256K LServe runs exceed the
            # reference's global max_seq_len=65536 default cap)
            self.max_model_len = max_model_len
        else:
            self.max_model_len = min(derived_max, MAX_SEQ_LEN)

    # -- HF config accessors (reference config.py:120-190) ----------------
    def get_hidden_size(self) -> int:
        return self.hf_config.hidden_size

    def get_head_size(self) -> int:
        if hasattr(self.hf_config, "head_dim") and self.hf_config.head_dim:
            return self.hf_config.head_dim
        return self.hf_config.hidden_size // self.hf_config.num_attention_heads

    def get_num_attention_heads(self, tp_size: int = 1) -> int:
        return self.hf_config.num_attention_heads // tp_size

    def get_num_kv_heads(self, tp_size: int = 1) -> int:
        n = getattr(
            self.hf_config,
            "num_key_value_heads",
            self.hf_config.num_attention_heads,
        )
        return max(1, n // tp_size)

    def get_num_layers(self) -> int:
        return self.hf_config.num_hidden_layers

    def get_vocab_size(self) -> int:
        return self.hf_config.vocab_size

    def get_intermediate_size(self) -> int:
        return self.hf_config.intermediate_size


@dataclasses.dataclass
class CacheConfig:
    """KV cache sizing: dual pools, each with a device and a host side.

    Reference config.py:219-222 keeps four pool sizes; page size fixed 64.
    """

    page_size: int = PAGE_SIZE
    num_retrieval_device_blocks: int = 0
    num_retrieval_cpu_blocks: int = 0
    num_streaming_device_blocks: int = 0
    num_streaming_cpu_blocks: int = 0
    memory_utilization: float = 0.9
    swap_space_gb: float = 4.0
    watermark: float = 0.01


@dataclasses.dataclass
class ParallelConfig:
    """Parallel sizes (same fields as the JAX package's config).

    The port serves on one device: every size above 1 is
    refused by the model runner (ROADMAP.md, queue 1 item 10).
    """

    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    sequence_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    # First device index of a data-parallel replica; not part of world_size.
    device_offset: int = 0

    @property
    def world_size(self) -> int:
        return (
            self.tensor_parallel_size
            * self.data_parallel_size
            * self.sequence_parallel_size
            * self.pipeline_parallel_size
        )

    def __post_init__(self) -> None:
        if self.pipeline_parallel_size < 1:
            raise ValueError("pipeline_parallel_size must be >= 1")


@dataclasses.dataclass
class SchedulerConfig:
    """Iteration-level scheduling budgets (reference config.py:311-358)."""

    max_num_batched_tokens: int = 2560
    max_num_seqs: int = 256
    max_model_len: int = MAX_SEQ_LEN
    chunk_prefill_size: int = 32000
    # max padding tokens admitted into one prefill batch (reference
    # arg_utils.py:269-274 / scheduler.py): prompts are right-padded to
    # the longest prompt in the batch, so mixing very unequal lengths
    # wastes compute — stop admitting when the pad total would exceed this
    max_paddings: int = 256

    def __post_init__(self) -> None:
        if self.max_num_batched_tokens < self.max_num_seqs:
            raise ValueError(
                "max_num_batched_tokens must be >= max_num_seqs "
                f"({self.max_num_batched_tokens} < {self.max_num_seqs})"
            )


@dataclasses.dataclass
class DeviceConfig:
    """The torch device the engine serves on (``cuda:0`` unless the caller
    asks for ``cpu``)."""

    device: str = "cuda:0"


@dataclasses.dataclass
class IFBConfig:
    """In-flight (continuous) batching toggle (reference config.py:365).

    ``decode_multi_step``: greedy decode tokens per worker call (a decode
    window; ``worker/decode_window.py``). 1 decodes one token per step."""

    ifb_mode: bool = True
    decode_multi_step: int = 1


@dataclasses.dataclass
class ProfilingConfig:
    """Fixed-shape random-prompt benchmarking (reference config.py:370)."""

    prompt_len: int = 1024
    generate_len: int = 512
