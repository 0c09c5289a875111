"""Paged decode attention (``csrc/decode_attention.cu``): the fused KV
append over a dense page list, dynamic-sparse decode over per-head page
lists and the streaming band over a ring pool (each over kv4 or kv8 pools,
fine-grained or per-tensor, at head_dim 128), and the two-stage decode's
three list modes (dense, per-head, band) over kv16 pools and over the kv4 /
kv8 pools the JAX package's ``supports`` rule keeps from the single-pass
kernels, at head_dim 64 or 128.

Replaces, of ``omniserve_tpu/ops/pallas/decode_attention.py``:

- ``paged_mqa_attention_single_pass`` (:620) in its ``append=`` mode over
  a dense, contiguous page list: ``paged_decode_attention_fused``. Its
  plain version, ``paged_decode_attention_fused_plain``, is the JAX
  package's split path (``omniserve_tpu/ops/dispatch.py:86-118``):
  ``append_kv`` of the new token, then
  ``attention_ref.paged_decode_attention`` over the updated pool. Both
  update the pool IN PLACE.
- ``paged_mqa_attention_single_pass_ph`` (:1119), per-(sequence, kv head)
  page lists from the selector: ``paged_mqa_attention_single_pass_ph``.
- ``paged_mqa_attention_single_pass`` in its plain mode with the streaming
  decode band and the ring relabel: ``paged_mqa_attention_single_pass``.

And of ``omniserve_tpu/ops/pallas/paged_attention.py``:

- ``paged_mqa_attention`` (:255), the two-stage decode the JAX package
  runs over kv16 pools and, where ``dispatch.supports`` is False (head_dim
  64, pages not a multiple of 128), over kv4 / kv8 pools, as one C entry
  that reads the listed pages in place (no gather stage): over a dense list
  (``paged_mqa_attention``), per-head lists (``paged_mqa_attention_ph``)
  and the streaming band with the ring relabel
  (``paged_mqa_attention_band``), any pool kind. Launches count per mode
  and pool kind (``paged_mqa_attention{,_ph,_band}`` +
  ``""`` kv4, ``_kv8``, ``_pt``; kv16 under ``paged_mqa_attention_kv16``,
  ``decode_attention_ph_kv16``, ``decode_attention_band_kv16``), with
  ``_d64`` at head_dim 64.

``paged_decode_attention`` composes the last two as
``omniserve_tpu/ops/pallas/paged_attention.py:paged_decode_attention``
(:535) does: route q heads to pool rows, build the page lists, run the
retrieval and the streaming call (rows 4 / 5 where ``supports`` holds,
row 6 everywhere else), merge by head. The list kernels share
one plain version, ``page_list_attention_plain``, which follows the list
contract; ``attention_ref.paged_decode_attention`` is the plain
version of the whole composition. What bounds the kernels and how they are
laid out is in the CUDA source's header.

Every kernel here splits each list over blocks (the fused append walks the
dense list of the block table): ``split_plan`` picks the number of splits S
from shapes the host knows (never from lengths or list contents: a captured
launch keeps its grid), and with S > 1 the kernels write f32 partials that
a second kernel merges (``combine_partials_plain`` is its plain version;
``page_list_partials_plain`` and ``fused_append_partials_plain`` give the
partials the kernels write).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from omniserve_tpu_torch.csrc import build
from omniserve_tpu_torch.ops import attention_ref, cuda
from omniserve_tpu_torch.ops.dispatch import supports
from omniserve_tpu_torch.ops.paged_kv import KVPool, append_kv

_P = ctypes.c_void_p
_I = ctypes.c_int
_SRC = "decode_attention.cu"
HEAD_DIM = 128      # rows 4 and 5 (the single-pass kernels' supports rule)
MAX_PAGE = cuda.MAX_PAGE


def _lib():
    lib = build.lib(_SRC)
    if not getattr(lib, "_typed", False):
        lib.launch_decode_attention_append.argtypes = (
            [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I] + [_P] * 3
        )
        lib.launch_decode_attention_append.restype = _I
        lib.launch_decode_attention_ph.argtypes = (
            [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I] + [_P] * 3
        )
        lib.launch_decode_attention_ph.restype = _I
        lib.launch_decode_attention_band.argtypes = (
            [_P] * 9 + [_I] * 6 + [ctypes.c_float] + [_I] * 5 + [_P] * 3
        )
        lib.launch_decode_attention_band.restype = _I
        lib.launch_paged_mqa_attention.argtypes = (
            [_I, _I] + [_P] * 11 + [_I] * 6 + [ctypes.c_float] + [_I] * 5
            + [_P]
        )
        lib.launch_paged_mqa_attention.restype = _I
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# The split over pages (per-head lists and kv16): plan, partials, combine
# ---------------------------------------------------------------------------

SPLIT_WAVES = 2   # blocks to aim for, in multiples of the SM count


def split_plan(b: int, h: int, tp: int, sm_count: int) -> Tuple[int, int]:
    """(S, per_split): each of the ``b * h`` page lists of ``tp`` entries
    is cut into S runs of ``per_split`` consecutive entries (the last run
    may be shorter, none is empty), one block each, so that about
    ``SPLIT_WAVES`` waves of blocks cover the card's ``sm_count`` SMs.
    Shapes only: the same call on any lengths or lists gets the same grid."""
    tp = max(int(tp), 1)
    want = -(-SPLIT_WAVES * int(sm_count) // max(int(b) * int(h), 1))
    per = -(-tp // min(max(want, 1), tp))
    return -(-tp // per), per


def _split_launch(q4, tp: int):
    """(per_split, workspace pointer or None) of a split kernel call on
    q4 [B, H, n_rep, D]: the f32 partials [S, B*H*n_rep] x (D + 2) live in
    a ``torch.empty`` (a captured step takes it from the graph's pool)."""
    b, h, n_rep, d = q4.shape
    n_split, per = split_plan(b, h, tp, cuda.sm_count(q4.device))
    if n_split == 1:
        return per, None, None
    ws = torch.empty(n_split * b * h * n_rep * (d + 2), dtype=torch.float32,
                     device=q4.device)
    return per, ws, ws.data_ptr()


def page_list_partials_plain(
    q, pool: KVPool, layer: int, sel_phys, sel_logic, lengths, *,
    sm_scale: float, page_size: int, per_split: int,
):
    """The partials a split kernel writes, in f32 (q [B, Hp, n_rep, D], the
    lists as ``page_list_attention_plain`` takes them): for each run s of
    ``per_split`` list entries, the row max ``m`` [S, B, Hp, n_rep] of the
    scores over its live slots (-inf if none), the sum ``l`` of exp(score
    - m) and the unnormalised ``acc`` [S, B, Hp, n_rep, D] = sum p v
    (0 where no slot is live)."""
    tp = sel_logic.shape[-1]
    ms, ls, accs = [], [], []
    for i0 in range(0, max(tp, 1), per_split):
        keep = torch.zeros(tp, dtype=torch.bool, device=sel_logic.device)
        keep[i0:i0 + per_split] = True
        logic = torch.where(keep, sel_logic, -1)
        k, v, valid = page_list_kv(pool, layer, sel_phys, logic, lengths,
                                   q.shape[1], page_size=page_size)
        scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), k) * sm_scale
        mask = valid[:, :, None].expand_as(scores)
        m = scores.masked_fill(~mask, float("-inf")).amax(dim=-1)
        p = torch.where(mask, torch.exp(scores - torch.where(
            mask.any(dim=-1), m, 0.0)[..., None]), 0.0)
        v = torch.where(valid[..., None], v, 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhrs,bhsd->bhrd", p, v))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials_plain(m, l, acc):
    """Plain version of the combine kernel (the log-sum-exp rule of
    ``omniserve_tpu/parallel/sp.py:sp_combine``): partials m, l [S, ...]
    and acc [S, ..., D] of disjoint parts of one softmax -> the f32
    attention output [..., D]; a part with m = -inf counts for nothing,
    and a row that no part saw gives 0."""
    live = m > float("-inf")
    m_star = m.amax(dim=0)
    e = torch.where(live, torch.exp(m - m_star), 0.0)
    num = torch.where(live[..., None], acc * e[..., None], 0.0).sum(dim=0)
    den = (l * e).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None], 0.0)


def append_targets(block_tables, context_lens, page_size):
    """(page id, slot) of each row's new token; page -1 for inactive rows.

    ``context_lens`` include the new token: it goes to logical page
    ``(len-1) // page`` (``omniserve_tpu/ops/pallas/paged_attention.py``
    :591-596)."""
    pos = torch.clamp(context_lens.long() - 1, min=0)
    pages = block_tables.long().gather(1, (pos // page_size)[:, None])[:, 0]
    pages = torch.where(context_lens > 0, pages, -1)
    return pages, pos % page_size


def paged_decode_attention_fused_plain(
    q, pool: KVPool, layer: int, block_tables, context_lens, k_new, v_new,
    *, sm_scale: float, page_size: int, kv_bits: int = 4,
    kv_zeros: bool = True,
):
    """Plain version: append the new token, then attend the updated pool
    (any width and granularity).

    q [B, Hq, D]; k_new/v_new [B, Hkv, D]. Returns [B, Hq, D]."""
    pages, slots = append_targets(block_tables, context_lens, page_size)
    append_kv(pool, layer, k_new, v_new, pages, slots, page_size,
              kv_bits=kv_bits, kv_zeros=kv_zeros)
    return attention_ref.paged_decode_attention(
        q, pool, layer, block_tables, context_lens, sm_scale, page_size,
        kv_bits=kv_bits, kv_zeros=kv_zeros,
    )


def fused_append_partials_plain(
    q, pool: KVPool, layer: int, block_tables, context_lens, k_new, v_new,
    *, sm_scale: float, page_size: int, per_split: int, kv_bits: int = 4,
    kv_zeros: bool = True,
):
    """The partials the fused decode kernel's split writes (q [B, Hq, D],
    the rest as ``paged_decode_attention_fused_plain`` takes them): the new
    token goes into the pool as the block that owns its page writes it
    (``append_kv``'s bytes), then each run of ``per_split`` entries of the
    dense list of the block table gives its m, l [S, B, Hkv, n_rep] and acc
    [S, B, Hkv, n_rep, D] (``page_list_partials_plain``): the token counts
    in the run that holds its page."""
    pages, slots = append_targets(block_tables, context_lens, page_size)
    append_kv(pool, layer, k_new, v_new, pages, slots, page_size,
              kv_bits=kv_bits, kv_zeros=kv_zeros)
    b, hq, d = q.shape
    hkv = k_new.shape[1]
    lists = dense_page_lists(block_tables, context_lens, page_size)
    return page_list_partials_plain(
        q.reshape(b, hkv, hq // hkv, d), pool, layer, *lists,
        context_lens.to(torch.int32), sm_scale=sm_scale,
        page_size=page_size, per_split=per_split)


def paged_decode_attention_fused(
    q: torch.Tensor,             # [B, Hq, D] bf16
    pool: KVPool,
    layer: int,
    block_tables: torch.Tensor,  # [B, W] int32
    context_lens: torch.Tensor,  # [B] int32, incl. the new token
    k_new: torch.Tensor,         # [B, Hkv, D] bf16
    v_new: torch.Tensor,         # [B, Hkv, D] bf16
    *,
    sm_scale: float,
    page_size: int,
    kv_bits: int = 4,
) -> torch.Tensor:
    """Kernel: attention over the pool plus the new token, whose K/V it
    quantizes and writes into the pool (kv4 or kv8; per-tensor codes when
    the pool carries per-tensor scales, read on the device), over the
    dense list of each row's block table split over blocks by
    ``split_plan`` (and merged by the combine kernel in the same call;
    pages of a multiple of 4 tokens). Returns [B, Hq, D] bf16. Launches
    count as ``decode_attention_append`` (kv4),
    ``decode_attention_append_kv8`` or ``decode_attention_append_pt``, one a
    call."""
    b, hq, d = q.shape
    _, num_pages, hkv, rows, _ = pool.k_data.shape
    n_rep = hq // hkv
    if d != HEAD_DIM or n_rep * hkv != hq or not 1 <= n_rep <= cuda.MAX_N_REP:
        raise ValueError(
            f"decode kernel needs head_dim {HEAD_DIM} and n_rep 1 to "
            f"{cuda.MAX_N_REP}; got head_dim {d}, {hq} q / {hkv} kv heads"
        )
    want_rows = {4: page_size // 2, 8: page_size}.get(kv_bits)
    pt = pool.k_scale_per_tensor is not None
    if (rows != want_rows or page_size > MAX_PAGE or page_size % 4
            or (pool.kv_scales is None) == (not pt)):
        raise ValueError("decode kernel serves kv4 and kv8 pools, fine-"
                         "grained or per-tensor, with pages of a multiple "
                         f"of 4 tokens up to {MAX_PAGE}; got kv{kv_bits}, "
                         f"{rows} rows of a {page_size}-token page")
    cuda.check(q, "q", torch.bfloat16)
    cuda.check(k_new, "k_new", torch.bfloat16, (b, hkv, d))
    cuda.check(v_new, "v_new", torch.bfloat16, (b, hkv, d))
    cuda.check(pool.k_data, "k_data", torch.uint8)
    cuda.check(pool.v_data, "v_data", torch.uint8, pool.k_data.shape)
    planes_ptr = k_pt = v_pt = None
    if pt:
        num_layers = pool.k_data.shape[0]
        cuda.check(pool.k_scale_per_tensor, "k_scale_per_tensor",
                   torch.float32, (num_layers,))
        cuda.check(pool.v_scale_per_tensor, "v_scale_per_tensor",
                   torch.float32, (num_layers,))
        # device addresses of this layer's scales: never read on the host
        k_pt = pool.k_scale_per_tensor[layer].data_ptr()
        v_pt = pool.v_scale_per_tensor[layer].data_ptr()
    else:
        cuda.check(pool.kv_scales, "kv_scales", torch.float32)
        planes_ptr = pool.kv_scales[layer].data_ptr()
    cuda.check(block_tables, "block_tables", torch.int32)
    cuda.check(context_lens, "context_lens", torch.int32, (b,))
    if block_tables.shape[0] != b:
        raise ValueError("block_tables rows != batch")
    out = torch.empty_like(q)
    w = block_tables.shape[1]
    per, ws, ws_ptr = _split_launch(q.view(b, hkv, n_rep, d), w)
    err = _lib().launch_decode_attention_append(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pool.k_data[layer].data_ptr(), pool.v_data[layer].data_ptr(),
        planes_ptr, block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), ws_ptr, b, hkv, n_rep, page_size, w, per,
        float(sm_scale), kv_bits, k_pt, v_pt, cuda.stream_handle(),
    )
    name = ("decode_attention_append_pt" if pt
            else "decode_attention_append_kv8" if kv_bits == 8
            else "decode_attention_append")
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# Decode over explicit page lists: per-head selections and the ring band
# ---------------------------------------------------------------------------


def list_mode(pool: KVPool, page_size: int):
    """(kv bits, per-tensor, launch-name suffix) of a kv4 / kv8 pool, the
    bits read from its page rows as the JAX kernels do: "" (fine-grained
    kv4), "_kv8" (fine-grained kv8) or "_pt" (per-tensor kv4 or kv8)."""
    kv_bits = 8 if pool.k_data.shape[3] == page_size else 4
    pt = pool.k_scale_per_tensor is not None
    return kv_bits, pt, "_pt" if pt else "_kv8" if kv_bits == 8 else ""


def _check_list_call(q4, pool: KVPool, head_dims) -> None:
    """Raise unless q4 [B, Hp, n_rep, D] fits a list kernel built for
    ``head_dims``: n_rep 1 to 8, one q group per pool head."""
    _, hp, n_rep, d = q4.shape
    cuda.check_head_dim(d, "decode kernel", head_dims)
    if not 1 <= n_rep <= cuda.MAX_N_REP or hp != pool.num_heads:
        raise ValueError(
            f"decode kernel needs n_rep 1 to {cuda.MAX_N_REP} and one q "
            f"group per pool head; got q {tuple(q4.shape)} for "
            f"{pool.num_heads} pool heads"
        )


def _list_call_args(q4, pool: KVPool, layer: int, sel_phys, sel_logic,
                    lengths, page_size: int, list_shape,
                    head_dims=(HEAD_DIM,)):
    """Check a list kernel call; returns (planes, k_pt, v_pt) device
    addresses (null where the mode has none), the kv bits and the launch-
    name suffix."""
    b = q4.shape[0]
    _check_list_call(q4, pool, head_dims)
    kv_bits, pt, suffix = list_mode(pool, page_size)
    rows = pool.k_data.shape[3]
    if (rows not in (page_size // 2, page_size) or page_size > MAX_PAGE
            or page_size % 4 or (pool.kv_scales is None) != pt):
        raise ValueError("decode kernel serves kv4 and kv8 pools, fine-"
                         "grained or per-tensor, with pages of a multiple "
                         f"of 4 tokens up to {MAX_PAGE}; got {rows} rows of "
                         f"a {page_size}-token page")
    cuda.check(q4, "q", torch.bfloat16)
    cuda.check(pool.k_data, "k_data", torch.uint8)
    cuda.check(pool.v_data, "v_data", torch.uint8, pool.k_data.shape)
    cuda.check(sel_phys, "sel_phys", torch.int32, list_shape)
    cuda.check(sel_logic, "sel_logic", torch.int32, list_shape)
    cuda.check(lengths, "lengths", torch.int32, (b,))
    planes = k_pt = v_pt = None
    if pt:
        num_layers = pool.k_data.shape[0]
        cuda.check(pool.k_scale_per_tensor, "k_scale_per_tensor",
                   torch.float32, (num_layers,))
        cuda.check(pool.v_scale_per_tensor, "v_scale_per_tensor",
                   torch.float32, (num_layers,))
        # device addresses of this layer's scales: never read on the host
        k_pt = pool.k_scale_per_tensor[layer].data_ptr()
        v_pt = pool.v_scale_per_tensor[layer].data_ptr()
    else:
        cuda.check(pool.kv_scales, "kv_scales", torch.float32)
        planes = pool.kv_scales[layer].data_ptr()
    return (planes, k_pt, v_pt), kv_bits, suffix


def paged_mqa_attention_single_pass_ph(
    q: torch.Tensor,          # [B, Hr, n_rep, D] bf16
    pool: KVPool,
    layer: int,
    sel_phys: torch.Tensor,   # [B, Hr, Tp] int32 physical page ids
    sel_logic: torch.Tensor,  # [B, Hr, Tp] int32 logical page, -1 = dead
    lengths: torch.Tensor,    # [B] int32
    *,
    sm_scale: float,
    page_size: int,
) -> torch.Tensor:
    """Kernel: dynamic-sparse decode over per-(sequence, head) page lists
    (in no order; all dead gives zeros) of a kv4 or kv8 pool, fine-grained
    or per-tensor, split over blocks by ``split_plan`` (and merged by the
    combine kernel in the same call). Returns [B, Hr, n_rep, D] bf16.
    Launches count as ``decode_attention_ph`` (fine-grained kv4),
    ``decode_attention_ph_kv8`` or ``decode_attention_ph_pt``, one a
    call."""
    b, hp, n_rep, _ = q.shape
    tp = sel_logic.shape[-1]
    (planes, k_pt, v_pt), kv_bits, suffix = _list_call_args(
        q, pool, layer, sel_phys, sel_logic, lengths, page_size,
        (b, hp, tp))
    out = torch.empty_like(q)
    per, ws, ws_ptr = _split_launch(q, tp)
    err = _lib().launch_decode_attention_ph(
        q.data_ptr(), pool.k_data[layer].data_ptr(),
        pool.v_data[layer].data_ptr(), planes, sel_phys.data_ptr(),
        sel_logic.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws_ptr, b,
        hp, n_rep, page_size, tp, per, float(sm_scale), kv_bits, k_pt, v_pt,
        cuda.stream_handle(),
    )
    name = "decode_attention_ph" + suffix
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return out


def paged_mqa_attention_single_pass(
    q: torch.Tensor,          # [B, Hp, n_rep, D] bf16
    pool: KVPool,
    layer: int,
    sel_phys: torch.Tensor,   # [B, Tp] int32, one list for all heads
    sel_logic: torch.Tensor,  # [B, Tp] int32 logical page, -1 = dead
    lengths: torch.Tensor,    # [B] int32
    *,
    sm_scale: float,
    page_size: int,
    band_sink_tokens: int = -1,
    band_local_tokens: int = 0,
    ring_span_pages: int = 0,
    ring_sink_tokens: int = 0,
) -> torch.Tensor:
    """Kernel: decode over one page list per sequence of a kv4 or kv8 pool
    (fine-grained or per-tensor), in its plain mode (no append).
    ``band_sink_tokens >= 0`` turns the streaming band on: only positions
    ``< band_sink_tokens`` or ``>= length - band_local_tokens`` are
    attended; ``ring_span_pages > 0`` relabels the slots past the write
    head of the page being written (they hold tokens one ring wrap older).
    The list is split over blocks as ``paged_mqa_attention_single_pass_ph``'s
    (pages of a multiple of 4 tokens). Returns [B, Hp, n_rep, D] bf16.
    Launches count as ``decode_attention_band`` (fine-grained kv4),
    ``decode_attention_band_kv8`` or ``decode_attention_band_pt``, one a
    call."""
    b, hp, n_rep, _ = q.shape
    tp = sel_logic.shape[-1]
    (planes, k_pt, v_pt), kv_bits, suffix = _list_call_args(
        q, pool, layer, sel_phys, sel_logic, lengths, page_size, (b, tp))
    out = torch.empty_like(q)
    per, ws, ws_ptr = _split_launch(q, tp)
    err = _lib().launch_decode_attention_band(
        q.data_ptr(), pool.k_data[layer].data_ptr(),
        pool.v_data[layer].data_ptr(), planes, sel_phys.data_ptr(),
        sel_logic.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws_ptr, b,
        hp, n_rep, page_size, tp, per, float(sm_scale),
        int(band_sink_tokens), int(band_local_tokens), int(ring_span_pages),
        int(ring_sink_tokens), kv_bits, k_pt, v_pt, cuda.stream_handle(),
    )
    name = "decode_attention_band" + suffix
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return out


# row 6's list modes: the C entry's list_mode and the launch-name stems
# (kv4 / kv8 pools: + "" / "_kv8" / "_pt"; kv16 pools keep the names they
# had before the kv4 / kv8 modes)
TWO_STAGE_MODES = {"dense": 0, "ph": 1, "band": 2}
_KV16_NAMES = {"dense": "paged_mqa_attention_kv16",
               "ph": "decode_attention_ph_kv16",
               "band": "decode_attention_band_kv16"}


def two_stage_name(mode: str, pool: KVPool, page_size: int,
                   head_dim: int) -> str:
    """The ``LAUNCHES`` entry of one row-6 call: list mode ``mode``
    ("dense", "ph", "band") over ``pool``, ``_d64`` at head_dim 64."""
    if pool.k_data.dtype == torch.bfloat16:
        base = _KV16_NAMES[mode]
    else:
        _, _, suffix = list_mode(pool, page_size)
        base = ("paged_mqa_attention" + {"dense": "", "ph": "_ph",
                                         "band": "_band"}[mode] + suffix)
    return cuda.launch_name(base, head_dim)


def _two_stage_launch(mode: str, q, pool: KVPool, layer: int, sel_phys,
                      sel_logic, lengths, page_size: int, sm_scale: float,
                      band=(0, 0, 0, 0)) -> torch.Tensor:
    """Check and launch row 6 in list mode ``mode`` over a kv16 pool or a
    kv4 / kv8 pool (fine-grained or per-tensor), split over blocks by
    ``split_plan`` (and merged by the combine kernel in the same call);
    counts one launch under ``two_stage_name``."""
    b, hp, n_rep, d = q.shape
    tp = sel_logic.shape[-1]
    list_shape = (b, hp, tp) if mode == "ph" else (b, tp)
    if pool.k_data.dtype == torch.bfloat16:
        _check_list_call(q, pool, cuda.HEAD_DIMS)
        if pool.k_data.shape[3] != page_size or page_size > MAX_PAGE:
            raise ValueError("kv16 decode kernel needs pages of at most "
                             f"{MAX_PAGE} tokens, one row each; got "
                             f"{pool.k_data.shape[3]} rows of a {page_size}-"
                             "token page")
        cuda.check(q, "q", torch.bfloat16)
        cuda.check(pool.k_data, "k_data", torch.bfloat16)
        cuda.check(pool.v_data, "v_data", torch.bfloat16, pool.k_data.shape)
        cuda.check(sel_phys, "sel_phys", torch.int32, list_shape)
        cuda.check(sel_logic, "sel_logic", torch.int32, list_shape)
        cuda.check(lengths, "lengths", torch.int32, (b,))
        (planes, k_pt, v_pt), kv_bits = (None, None, None), 16
    else:
        (planes, k_pt, v_pt), kv_bits, _ = _list_call_args(
            q, pool, layer, sel_phys, sel_logic, lengths, page_size,
            list_shape, cuda.HEAD_DIMS)
    out = torch.empty_like(q)
    per, ws, ws_ptr = _split_launch(q, tp)
    err = _lib().launch_paged_mqa_attention(
        TWO_STAGE_MODES[mode], kv_bits, q.data_ptr(),
        pool.k_data[layer].data_ptr(), pool.v_data[layer].data_ptr(), planes,
        k_pt, v_pt, sel_phys.data_ptr(), sel_logic.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ws_ptr, b, hp, n_rep, page_size,
        tp, per, float(sm_scale), *band, d, cuda.stream_handle(),
    )
    name = two_stage_name(mode, pool, page_size, d)
    cuda.raise_on_error(err, name)
    cuda.LAUNCHES[name] += 1
    return out


def paged_mqa_attention(
    q: torch.Tensor,          # [B, H, n_rep, D] bf16
    pool: KVPool,
    layer: int,
    sel_phys: torch.Tensor,   # [B, Tp] int32, one list for all heads
    sel_logic: torch.Tensor,  # [B, Tp] int32 logical page, -1 = dead
    lengths: torch.Tensor,    # [B] int32
    *,
    sm_scale: float,
    page_size: int,
) -> torch.Tensor:
    """Kernel (row 6): decode over one page list per sequence, the pages
    read in place, over a kv16 pool or a kv4 / kv8 pool (fine-grained or
    per-tensor), head_dim 64 or 128. Returns [B, H, n_rep, D] bf16.
    Launches count under ``two_stage_name("dense", ...)``, one a call."""
    return _two_stage_launch("dense", q, pool, layer, sel_phys, sel_logic,
                             lengths, page_size, sm_scale)


def paged_mqa_attention_ph(
    q: torch.Tensor,          # [B, Hr, n_rep, D] bf16
    pool: KVPool,
    layer: int,
    sel_phys: torch.Tensor,   # [B, Hr, Tp] int32 physical page ids
    sel_logic: torch.Tensor,  # [B, Hr, Tp] int32 logical page, -1 = dead
    lengths: torch.Tensor,    # [B] int32
    *,
    sm_scale: float,
    page_size: int,
) -> torch.Tensor:
    """Kernel (row 6, ``per_head_sel``): dynamic-sparse decode over
    per-(sequence, head) page lists (in no order; all dead gives zeros),
    any pool kind as ``paged_mqa_attention``. Returns [B, Hr, n_rep, D]
    bf16; one launch under ``two_stage_name("ph", ...)``."""
    return _two_stage_launch("ph", q, pool, layer, sel_phys, sel_logic,
                             lengths, page_size, sm_scale)


def paged_mqa_attention_band(
    q: torch.Tensor,          # [B, Hs, n_rep, D] bf16
    pool: KVPool,             # the ring pool
    layer: int,
    sel_phys: torch.Tensor,   # [B, Tp] int32, one list for all heads
    sel_logic: torch.Tensor,  # [B, Tp] int32 logical page, -1 = dead
    lengths: torch.Tensor,    # [B] int32
    *,
    sm_scale: float,
    page_size: int,
    band_sink_tokens: int = 0,
    band_local_tokens: int = 0,
    ring_span_pages: int = 0,
    ring_sink_tokens: int = 0,
) -> torch.Tensor:
    """Kernel (row 6's band mode): the streaming band over one page list
    per sequence of a ring pool, any pool kind as ``paged_mqa_attention``:
    only positions ``< band_sink_tokens`` or ``>= length -
    band_local_tokens`` are attended, and ``ring_span_pages > 0`` relabels
    the slots past the write head of the page being written. Returns [B,
    Hs, n_rep, D] bf16; one launch under ``two_stage_name("band", ...)``."""
    if band_sink_tokens < 0:
        raise ValueError("the band kernel needs band_sink_tokens >= 0")
    return _two_stage_launch(
        "band", q, pool, layer, sel_phys, sel_logic, lengths, page_size,
        sm_scale, (int(band_sink_tokens), int(band_local_tokens),
                   int(ring_span_pages), int(ring_sink_tokens)))


def page_list_kv(
    pool: KVPool, layer: int, sel_phys, sel_logic, lengths, n_heads: int,
    *, page_size: int, band_sink_tokens: int = -1,
    band_local_tokens: int = 0, ring_span_pages: int = 0,
    ring_sink_tokens: int = 0,
):
    """The listed pages of a kv4 / kv8 pool (fine-grained or per-tensor)
    or a kv16 pool, dequantized: (k, v) [B, Hp, Tp*page, D] f32 and
    ``valid`` [B, Hp, Tp*page], each slot live as the list contract says
    (position below the length, the ring relabel, the band). Lists are
    [B, Hp, Tp] (per head) or [B, Tp] (shared by the ``n_heads`` heads)."""
    b = lengths.shape[0]
    if sel_logic.dim() == 2:
        sel_phys = sel_phys[:, None, :].expand(b, n_heads, -1)
        sel_logic = sel_logic[:, None, :].expand(b, n_heads, -1)
    dev = sel_logic.device
    logic = sel_logic.long()
    phys = torch.where(logic >= 0, sel_phys.long(), 0)
    heads = torch.arange(n_heads, device=dev)[None, :, None]
    if pool.k_data.dtype == torch.bfloat16:            # kv16: values as is
        k = pool.k_data[layer][phys, heads].float()    # [B, Hp, Tp, page, D]
        v = pool.v_data[layer][phys, heads].float()
    else:
        kv_bits, pt, _ = list_mode(pool, page_size)

        def values(data, scale, zero):
            pages = data[layer][phys, heads]           # [B, Hp, Tp, rows, D]
            if kv_bits == 8:                           # row = slot
                codes = pages.float()
            else:                                      # half-split nibbles
                codes = torch.cat([(pages & 0xF).float(),
                                   (pages >> 4).float()], dim=-2)
            return (codes - zero) * scale              # [B, Hp, Tp, page, D]

        if pt:      # biased codes times the layer's scale
            bias = 128.0 if kv_bits == 8 else 8.0
            k = values(pool.k_data, pool.k_scale_per_tensor[layer], bias)
            v = values(pool.v_data, pool.v_scale_per_tensor[layer], bias)
        else:
            planes = pool.kv_scales[layer][phys, :, heads]  # [B,Hp,Tp,4,pg]
            k_scale = planes[..., 0, :, None]
            k = values(pool.k_data, k_scale,
                       planes[..., 1, :, None]
                       / torch.clamp(k_scale, min=1e-20) - 128.0)
            v = values(pool.v_data, planes[..., 2, :, None],
                       planes[..., 3, :, None] - 128.0)

    ln = lengths.long()[:, None, None, None]
    slot = torch.arange(page_size, device=dev)
    pos = logic[..., None] * page_size + slot          # [B, Hp, Tp, page]
    floor = torch.zeros_like(pos)
    if band_sink_tokens >= 0 and ring_span_pages > 0:
        cur = torch.div(ln - 1, page_size, rounding_mode="floor")
        stale = (logic[..., None] == cur) & (
            slot > torch.remainder(ln - 1, page_size))
        pos = torch.where(stale, pos - ring_span_pages * page_size, pos)
        floor = torch.where(stale, ring_sink_tokens, 0)
    valid = (logic[..., None] >= 0) & (pos < ln) & (pos >= floor)
    if band_sink_tokens >= 0:
        win = torch.clamp(ln - band_local_tokens, min=0)
        valid = valid & ((pos < band_sink_tokens) | (pos >= win))
    return k.flatten(2, 3), v.flatten(2, 3), valid.flatten(2)


def page_list_attention_plain(
    q, pool: KVPool, layer: int, sel_phys, sel_logic, lengths, *,
    sm_scale: float, page_size: int, **list_kw,
) -> torch.Tensor:
    """Plain version of the list kernels (q [B, Hp, n_rep, D]; the lists
    and ``list_kw`` as ``page_list_kv`` takes them): gathers and
    dequantizes the listed pages and runs a masked softmax in f32."""
    k, v, valid = page_list_kv(pool, layer, sel_phys, sel_logic, lengths,
                               q.shape[1], page_size=page_size, **list_kw)
    scores = torch.einsum("bhrd,bhsd->bhrs", q.float(), k) * sm_scale
    mask = valid[:, :, None].expand_as(scores)
    scores = scores.masked_fill(~mask, float("-inf"))
    any_valid = mask.any(dim=-1, keepdim=True)
    m = torch.where(any_valid, scores.amax(dim=-1, keepdim=True), 0.0)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    probs = torch.where(
        any_valid, p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30),
        0.0)
    # never-written slots may hold non-finite planes: zero them before the
    # product (a zero weight would not silence a NaN)
    v = torch.where(valid[..., None], v, 0.0)
    return torch.einsum("bhrs,bhsd->bhrd", probs, v).to(q.dtype)


def uses_two_stage(pool: KVPool, page_size: int, head_dim: int) -> bool:
    """Whether decode over ``pool`` runs row 6 (the two-stage kernel) and
    not rows 4 / 5: the JAX package's routing
    (``omniserve_tpu/ops/pallas/paged_attention.py:584, 616-685,
    754-780``): a kv16 pool always, a kv4 / kv8 pool wherever
    ``dispatch.supports`` is False."""
    if pool.k_data.dtype == torch.bfloat16:
        return True
    kv_bits, _, _ = list_mode(pool, page_size)
    return not supports(kv_bits, page_size, head_dim)


def pool_head_sources(head_rank, flags, n_pool_heads: int,
                      want_retrieval: bool) -> torch.Tensor:
    """For each pool row r: the kv head that maps to it (inverse of rank);
    rows no head maps to repeat head 0 (never read back)."""
    rows = torch.arange(n_pool_heads, device=flags.device)
    sel = flags if want_retrieval else ~flags
    match = (head_rank[None, :] == rows[:, None]) & sel[None, :]
    return match.int().argmax(dim=1)


def selected_page_lists(page_idxes, block_tables, src_r):
    """Selector output [B, Hkv, n_sel] (logical pages, -1 pad) -> the
    retrieval pool's per-row lists (sel_phys, sel_logic) [B, Hr, n_sel]."""
    sel_logic = page_idxes[:, src_r].to(torch.int32)
    safe = torch.clamp(sel_logic.long(), 0, block_tables.shape[1] - 1)
    bsel = torch.gather(
        block_tables[:, None, :].expand(-1, sel_logic.shape[1], -1), 2, safe)
    sel_phys = torch.where(sel_logic >= 0, bsel, 0).to(torch.int32)
    return sel_phys.contiguous(), sel_logic.contiguous()


def dense_page_lists(block_tables, context_lens, page_size: int):
    """(sel_phys, sel_logic) [B, W] of a dense history: list position ==
    logical page, pages past the context dead."""
    n_pages = torch.div(context_lens.long() + page_size - 1, page_size,
                        rounding_mode="floor")
    tile = torch.arange(block_tables.shape[1], device=block_tables.device)
    sel_logic = torch.where(tile[None, :] < n_pages[:, None], tile[None, :],
                            -1)
    sel_phys = torch.where(sel_logic >= 0, block_tables, 0)
    return (sel_phys.to(torch.int32).contiguous(),
            sel_logic.to(torch.int32).contiguous())


def streaming_page_lists(streaming_block_tables, context_lens,
                         sink_blocks: int, page_size: int,
                         dec_local_tokens: int):
    """The COMPACT list of the streaming call: the sink blocks, then the
    newest ring blocks that intersect the decode band, each resolved to the
    LOGICAL block its ring slot holds (so positions are true token
    positions). Returns (sel_phys, sel_logic) [B, sink + n] int32 and the
    ring span in pages."""
    st = streaming_block_tables
    n_slots = st.shape[1]
    ring_local = max(1, n_slots - sink_blocks)
    dec_local_b = min(ring_local, -(-int(dec_local_tokens) // page_size) + 1)
    sink_eff = min(sink_blocks, n_slots)
    lens = context_lens.long()[:, None]
    dev = st.device
    cb = torch.clamp(torch.div(lens - 1, page_size, rounding_mode="floor"),
                     min=0)                              # [B, 1]
    blk = cb - torch.arange(dec_local_b, device=dev)[None, :]
    ring_slot = sink_blocks + torch.remainder(blk - sink_blocks, ring_local)
    ok_ring = (blk >= sink_blocks) & (lens > 0)
    logic_ring = torch.where(ok_ring, blk, -1)
    phys_ring = torch.gather(st.long(), 1,
                             torch.clamp(ring_slot, 0, n_slots - 1))
    sink_ids = torch.arange(sink_eff, device=dev)[None, :]
    logic_sink = torch.where((sink_ids <= cb) & (lens > 0), sink_ids, -1)
    sel_logic = torch.cat([logic_sink, logic_ring], dim=1)
    sel_phys = torch.cat([st[:, :sink_eff].long(), phys_ring], dim=1)
    sel_phys = torch.where(sel_logic >= 0, sel_phys, 0)
    return (sel_phys.to(torch.int32).contiguous(),
            sel_logic.to(torch.int32).contiguous(), ring_local)


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, D]
    pool: KVPool,
    layer: int,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    context_lens: torch.Tensor,  # [B] int32
    sm_scale: float,
    page_size: int,
    streaming_pool: Optional[KVPool] = None,
    streaming_block_tables: Optional[torch.Tensor] = None,
    head_is_retrieval: Optional[torch.Tensor] = None,
    head_rank: Optional[torch.Tensor] = None,
    sink_blocks: int = 0,
    local_blocks: int = 0,
    page_idxes: Optional[torch.Tensor] = None,
    dec_sink_tokens: Optional[int] = None,
    dec_local_tokens: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention (no append) over the dual pools through the list
    kernels; same results as ``attention_ref.paged_decode_attention``.

    Retrieval heads attend their selected pages (``page_idxes``) or, without
    a selection, their dense history; streaming heads attend the sink +
    local band of the ring pool. CUDA tensors go to the kernels, CPU
    tensors to ``page_list_attention_plain``."""
    b, hq, d = q.shape
    on_card = cuda.use_kernel(q)
    lengths = context_lens.to(torch.int32)
    pure_dense = head_is_retrieval is None
    hkv = pool.num_heads if pure_dense else head_is_retrieval.shape[0]
    n_rep = hq // hkv
    q_g = q.reshape(b, hkv, n_rep, d)

    hr = pool.num_heads
    if pure_dense:
        src_r = torch.arange(hr, device=q.device)
        q_r = q_g
    else:
        src_r = pool_head_sources(head_rank, head_is_retrieval, hr, True)
        q_r = q_g[:, src_r].contiguous()
    kw = dict(sm_scale=sm_scale, page_size=page_size)
    # the single-pass kernels (rows 4, 5) where the JAX package's supports
    # rule holds, the two-stage kernel's modes (row 6) everywhere else:
    # every kv16 pool, head_dim 64, pages not a multiple of 128
    two_stage = uses_two_stage(pool, page_size, d)
    if page_idxes is not None:
        lists = selected_page_lists(page_idxes, block_tables, src_r)
        kernel = (paged_mqa_attention_ph if two_stage
                  else paged_mqa_attention_single_pass_ph)
    else:
        lists = dense_page_lists(block_tables, context_lens, page_size)
        kernel = (paged_mqa_attention if two_stage
                  else paged_mqa_attention_single_pass)
    fn = kernel if on_card else page_list_attention_plain
    out_r = fn(q_r, pool, layer, *lists, lengths, **kw)
    if pure_dense:
        return out_r.reshape(b, hq, d)
    out = out_r[:, torch.clamp(head_rank.long(), 0, hr - 1)]
    if streaming_pool is None:
        return out.reshape(b, hq, d)

    hs = streaming_pool.num_heads
    src_s = pool_head_sources(head_rank, head_is_retrieval, hs, False)
    if dec_sink_tokens is None:
        dec_sink_tokens = sink_blocks * page_size
    if dec_local_tokens is None:
        dec_local_tokens = local_blocks * page_size
    sel_phys_s, sel_logic_s, ring_local = streaming_page_lists(
        streaming_block_tables, context_lens, sink_blocks, page_size,
        dec_local_tokens)
    kernel = (paged_mqa_attention_band
              if uses_two_stage(streaming_pool, page_size, d)
              else paged_mqa_attention_single_pass)
    fn = kernel if on_card else page_list_attention_plain
    out_s = fn(
        q_g[:, src_s].contiguous(), streaming_pool, layer, sel_phys_s,
        sel_logic_s, lengths, band_sink_tokens=int(dec_sink_tokens),
        band_local_tokens=int(dec_local_tokens), ring_span_pages=ring_local,
        ring_sink_tokens=sink_blocks * page_size, **kw)
    out_s = out_s[:, torch.clamp(head_rank.long(), 0, hs - 1)]
    out = torch.where(head_is_retrieval[None, :, None, None], out, out_s)
    return out.reshape(b, hq, d)
