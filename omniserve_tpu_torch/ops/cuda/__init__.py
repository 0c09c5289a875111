"""Hand-written Hopper kernels of the port and their launch counts.

Each module here mirrors a module of ``omniserve_tpu/ops/pallas/``: a
wrapper that checks its tensors and launches a CUDA kernel built from
``omniserve_tpu_torch/csrc/`` (on a CUDA tensor it launches or raises), and
beside it the plain PyTorch version the kernel is held against.

``LAUNCHES`` counts launches per kernel: a wrapper adds one where it
launches and nowhere else, so a run can show that the main path went
through the kernels. The callers (``ops/matmul.py``, ``ops/dispatch.py``)
send a CUDA tensor to the kernel and a CPU tensor to the plain version;
inside ``plain_versions()`` they send CUDA tensors to the plain versions
too, which is how a check runs both on the same card.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# q heads a kv head (n_rep) every attention kernel takes: 1 to 8 (the
# decode kernels' largest row capacity; rows 7 and 8 hold BM / n_rep whole
# tokens a block). ``LlamaSpec.check_supported`` refuses the rest.
MAX_N_REP = 8

# head dims the attention, decode and append kernels are built for (rows
# 6, 7, 9 and 10 take both; rows 4, 5 and 8 only 128, the JAX package's
# ``supports`` rule), and the tokens a page may hold (the decode kernels
# stage a page whole). ``LlamaSpec.check_supported`` refuses the rest on a
# card.
HEAD_DIMS = (64, 128)
MAX_PAGE = 256

# the kernels a head_dim-64 call may reach: each counts its head_dim-64
# launches under its name + "_d64" (``launch_name``)
D64_KERNELS = (
    "paged_mqa_attention",
    "paged_mqa_attention_kv8",
    "paged_mqa_attention_pt",
    "paged_mqa_attention_kv16",
    "paged_mqa_attention_ph",
    "paged_mqa_attention_ph_kv8",
    "paged_mqa_attention_ph_pt",
    "decode_attention_ph_kv16",
    "paged_mqa_attention_band",
    "paged_mqa_attention_band_kv8",
    "paged_mqa_attention_band_pt",
    "decode_attention_band_kv16",
    "kv_append_decode",
    "kv_append_decode_kv8",
    "kv_append_decode_pt",
    "kv_append_decode_kv16",
    "flash_prefill",
    "flash_prefill_band",
    "paged_prefill_attention",
    "paged_prefill_ring",
    "paged_prefill_ring_kv8",
    "paged_prefill_ring_pt",
    "paged_prefill_ring_kv16",
    "paged_prefill_kv8",
    "paged_prefill_kv16",
    "paged_prefill_pt",
)

# the GEMM kernels a MoE layer's expert GEMMs reach: inside
# ``expert_launches()`` each counts under its name + "_moe"
MOE_KERNELS = ("w4a8_matmul_per_channel", "w4a8_matmul_per_group",
               "w8a8_matmul")

LAUNCHES = {
    "w4a8_matmul_per_channel": 0,
    "w4a8_matmul_per_group": 0,
    "w8a8_matmul": 0,
    "decode_attention_append": 0,
    "decode_attention_append_kv8": 0,
    "decode_attention_append_pt": 0,
    "paged_mqa_attention": 0,
    "paged_mqa_attention_kv8": 0,
    "paged_mqa_attention_pt": 0,
    "paged_mqa_attention_kv16": 0,
    "paged_mqa_attention_ph": 0,
    "paged_mqa_attention_ph_kv8": 0,
    "paged_mqa_attention_ph_pt": 0,
    "paged_mqa_attention_band": 0,
    "paged_mqa_attention_band_kv8": 0,
    "paged_mqa_attention_band_pt": 0,
    "decode_attention_ph": 0,
    "decode_attention_ph_kv8": 0,
    "decode_attention_ph_pt": 0,
    "decode_attention_ph_kv16": 0,
    "decode_attention_band": 0,
    "decode_attention_band_kv8": 0,
    "decode_attention_band_pt": 0,
    "decode_attention_band_kv16": 0,
    "kv_append_decode": 0,
    "kv_append_decode_kv8": 0,
    "kv_append_decode_pt": 0,
    "kv_append_decode_kv16": 0,
    "flash_prefill": 0,
    "flash_prefill_band": 0,
    "paged_prefill_attention": 0,
    "paged_prefill_ring": 0,
    "paged_prefill_ring_kv8": 0,
    "paged_prefill_ring_pt": 0,
    "paged_prefill_ring_kv16": 0,
    "paged_prefill_kv8": 0,
    "paged_prefill_kv16": 0,
    "paged_prefill_pt": 0,
    "paged_prefill_single_pass": 0,
    "paged_prefill_single_pass_kv8": 0,
    "paged_prefill_single_pass_pt": 0,
    "paged_prefill_single_pass_list": 0,
    "embed_gather": 0,
    **{name + "_d64": 0 for name in D64_KERNELS},
    **{name + "_moe": 0 for name in MOE_KERNELS},
}


def launch_name(name: str, head_dim: int) -> str:
    """The ``LAUNCHES`` entry of one launch: ``name``, or ``name + "_d64"``
    at head_dim 64."""
    return name + "_d64" if head_dim == 64 else name


def check_head_dim(d: int, kernel: str, dims=HEAD_DIMS) -> None:
    """Raise unless the kernel is built for head dim ``d``."""
    if d not in dims:
        raise ValueError(f"{kernel} is built for head_dim "
                         f"{' or '.join(map(str, dims))}, got {d}")


_force_plain = False
_gemm_suffix = ""


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_versions():
    """Within the block, CUDA tensors also go to the plain versions."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


@contextlib.contextmanager
def expert_launches():
    """Within the block, the GEMM wrappers count their launches under
    name + "_moe" (``gemm_launch_name``): a MoE layer's expert GEMMs."""
    global _gemm_suffix
    prev, _gemm_suffix = _gemm_suffix, "_moe"
    try:
        yield
    finally:
        _gemm_suffix = prev


def gemm_launch_name(name: str) -> str:
    """The ``LAUNCHES`` entry of one GEMM launch (``expert_launches``)."""
    return name + _gemm_suffix


def use_kernel(t: torch.Tensor) -> bool:
    """Whether the callers send this tensor to a kernel wrapper."""
    return t.is_cuda and not _force_plain


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device, read once: the split plans' input."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")
