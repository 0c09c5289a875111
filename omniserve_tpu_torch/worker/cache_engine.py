"""KV cache engine: owns the device KV pools and their page copy/swap ops.

Counterpart of ``omniserve_tpu.worker.cache_engine``: the retrieval pool
(with K min/max stats under sparse decode) and, when LServe splits the kv
heads, the streaming ring pool, as kv4 or kv8 pools (fine-grained or
per-tensor) or kv16 pools of torch tensors on the engine's device. Pools
hold a page COUNT (the engine's ``num_*_device_blocks``), as in the JAX
package; their bytes follow from the KV width (``pool_bytes``): a 128-token
page of one layer and kv head holds 16 KiB of K+V codes at kv4, 32 KiB at
kv8 and 64 KiB of bf16 values at kv16 (head dim 128), plus 2 KiB of f32
planes when fine-grained. Per-tensor pools start with unit scales, as
under dummy weights; ``load_kv_scales`` loads a checkpoint's calibrated
ones. Page ops update the pools in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from omniserve_tpu_torch.attn_config import SpAttnConfig
from omniserve_tpu_torch.config import CacheConfig, ModelConfig
from omniserve_tpu_torch.ops.paged_kv import KVPool, make_kv_pool
from omniserve_tpu_torch.utils.logger import init_logger

logger = init_logger(__name__)

_FIELDS = ("k_data", "v_data", "kv_scales", "k_stats")


def _fields(pool: KVPool):
    return [(n, getattr(pool, n)) for n in _FIELDS
            if getattr(pool, n) is not None]


def pool_bytes(pool: Optional[KVPool]) -> Dict[str, int]:
    """Bytes of each tensor of a pool (empty for no pool)."""
    if pool is None:
        return {}
    return {n: t.numel() * t.element_size() for n, t in _fields(pool)}


class CacheEngine:
    """Allocates and manipulates the dual KV pools for one worker."""

    def __init__(
        self,
        model_config: ModelConfig,
        cache_config: CacheConfig,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        sp_attn_config: Optional[SpAttnConfig] = None,
        device="cuda:0",
    ) -> None:
        self.cache_config = cache_config
        self.device = torch.device(device)
        sparse_decode = bool(
            sp_attn_config and sp_attn_config.dec.sparse_decode_mode
        )
        enable_streaming = bool(
            sp_attn_config and sp_attn_config.enable_streaming
        )
        # Pool head width = the largest per-layer pool population (a
        # per-layer rank table maps kv heads onto pool rows).
        if enable_streaming:
            n_retrieval_heads = sp_attn_config.max_retrieval_heads()
            n_streaming_heads = max(1, sp_attn_config.max_streaming_heads())
        else:
            n_retrieval_heads = num_kv_heads
            n_streaming_heads = 0
        common = dict(
            num_layers=num_layers, page_size=cache_config.page_size,
            head_dim=head_dim, kv_bits=model_config.kv_cache_bits,
            kv_zeros=model_config.kv_zeros, device=self.device,
        )
        self.retrieval_pool = make_kv_pool(
            num_pages=cache_config.num_retrieval_device_blocks,
            num_heads=n_retrieval_heads,
            with_stats=sparse_decode,
            sub_chunks=(sp_attn_config.dec.sub_chunk_per_block
                        if sp_attn_config else 4),
            **common,
        )
        self.streaming_pool: Optional[KVPool] = None
        if enable_streaming and cache_config.num_streaming_device_blocks > 0:
            self.streaming_pool = make_kv_pool(
                num_pages=cache_config.num_streaming_device_blocks,
                num_heads=n_streaming_heads, **common,
            )
        # host swap storage per pool: cpu page id -> {field: tensor [L, ...]}
        self._cpu_pages: Dict[bool, Dict[int, Dict[str, torch.Tensor]]] = {
            False: {}, True: {},
        }
        mib = 1 << 20
        r_bytes = pool_bytes(self.retrieval_pool)
        s_bytes = pool_bytes(self.streaming_pool)
        logger.info(
            "kv%d KV pools on %s: retrieval %d pages x %d heads, %.1f MiB "
            "(K stats %.1f MiB); streaming %s",
            model_config.kv_cache_bits, self.device,
            cache_config.num_retrieval_device_blocks,
            n_retrieval_heads, sum(r_bytes.values()) / mib,
            r_bytes.get("k_stats", 0) / mib,
            (f"{cache_config.num_streaming_device_blocks} pages x "
             f"{n_streaming_heads} heads, {sum(s_bytes.values()) / mib:.1f} "
             "MiB" if self.streaming_pool is not None else "off"),
        )

    def load_kv_scales(self, kv_scales: Tuple[torch.Tensor, torch.Tensor]
                       ) -> None:
        """Calibrated per-tensor K and V scales ([L] each) into every
        per-tensor pool, in place."""
        k_pt, v_pt = kv_scales
        for pool in (self.retrieval_pool, self.streaming_pool):
            if pool is None or pool.k_scale_per_tensor is None:
                continue
            pool.k_scale_per_tensor.copy_(torch.as_tensor(k_pt))
            pool.v_scale_per_tensor.copy_(torch.as_tensor(v_pt))

    def _pool(self, streaming: bool) -> KVPool:
        pool = self.streaming_pool if streaming else self.retrieval_pool
        if pool is None:
            raise ValueError("page op on the streaming pool, but this "
                             "engine has none")
        return pool

    def copy_pages(self, mapping: Dict[int, List[int]], streaming: bool
                   ) -> None:
        """Copy whole pages src -> dst across all layers (copy-on-write)."""
        if not mapping:
            return
        src = [s for s, ds in mapping.items() for _ in ds]
        dst = [d for ds in mapping.values() for d in ds]
        src_t = torch.tensor(src, device=self.device)
        dst_t = torch.tensor(dst, device=self.device)
        for _, arr in _fields(self._pool(streaming)):
            arr[:, dst_t] = arr[:, src_t]

    def swap_out(self, mapping: Dict[int, int], streaming: bool) -> None:
        """Device pages -> host (mapping: device page id -> cpu page id)."""
        if not mapping:
            return
        pool = self._pool(streaming)
        for dev_id, cpu_id in mapping.items():
            self._cpu_pages[streaming][cpu_id] = {
                name: arr[:, dev_id].to("cpu", copy=True)
                for name, arr in _fields(pool)
            }

    def swap_in(self, mapping: Dict[int, int], streaming: bool) -> None:
        """Host pages -> device (mapping: cpu page id -> device page id)."""
        if not mapping:
            return
        pool = self._pool(streaming)
        for cpu_id, dev_id in mapping.items():
            snap = self._cpu_pages[streaming].pop(cpu_id)
            for name, arr in _fields(pool):
                arr[:, dev_id] = snap[name].to(self.device)
