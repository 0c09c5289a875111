"""Native code of the port: CUDA kernel sources (``*.cu``) and the
host-side batch preparation (``host_prep.cc``), all built by ``build.py``
(``host_prep.cc`` with the host ``g++``) on first use and bound with
ctypes. A failed build raises with the compiler's output: the runner never
falls back.

The ``*_plain`` functions are the numpy versions of the two entry points;
the tests hold the library to them byte for byte.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Tuple

import numpy as np

from omniserve_tpu_torch.csrc import build

HOST_PREP = "host_prep.cc"


def get_lib() -> ctypes.CDLL:
    """The loaded host-prep library, built first if needed."""
    lib = build.lib(HOST_PREP)
    if lib.build_decode_batch.argtypes is None:
        i32p = ctypes.POINTER(ctypes.c_int32)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.pad_block_tables.restype = None
        lib.pad_block_tables.argtypes = [
            i32p, i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int32, i32p,
        ]
        lib.build_decode_batch.restype = ctypes.c_int
        lib.build_decode_batch.argtypes = [
            ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int,
            i32p, i32p, i8p, i32p, i32p, i32p, ctypes.c_int,
        ]
    return lib


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _flat(tables) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged tables -> (concatenated int32 values, int32 lengths)."""
    lens = np.fromiter(map(len, tables), np.int32, count=len(tables))
    flat = np.fromiter(itertools.chain.from_iterable(tables), np.int32,
                       count=int(lens.sum()))
    return flat, lens


def pad_block_tables(tables: List[List[int]], width: int,
                     fill: int = 0) -> np.ndarray:
    """Ragged tables -> dense [n, width] int32."""
    out = np.empty((len(tables), width), np.int32)
    flat, lens = _flat(tables)
    get_lib().pad_block_tables(_p32(flat), _p32(lens), len(tables), width,
                               np.int32(fill), _p32(out))
    return out


def pad_block_tables_plain(tables: List[List[int]], width: int,
                           fill: int = 0) -> np.ndarray:
    """The numpy version of ``pad_block_tables``."""
    out = np.full((len(tables), width), fill, np.int32)
    for i, t in enumerate(tables):
        out[i, : min(len(t), width)] = t[:width]
    return out


def _decode_buffers(b_pad: int, w: int, sw: int, max_new_pages: int):
    return (np.zeros(b_pad, np.int32), np.zeros(b_pad, np.int32),
            np.zeros(b_pad, np.int8), np.zeros((b_pad, w), np.int32),
            np.zeros((b_pad, sw), np.int32),
            np.full(max_new_pages, -1, np.int32))


def build_decode_batch(
    entries, page_size: int, b_pad: int, w: int, sw: int,
    max_new_pages: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, int]:
    """entries: list of (slot, token, position, block table, streaming
    block table), one per running sequence; slots without an entry are
    inactive.

    Returns (token_ids [b_pad], positions [b_pad], active [b_pad] bool,
    block tables [b_pad, w], streaming block tables [b_pad, sw], new pages
    [max_new_pages] (-1 padded), their count): the page each entry's
    token starts, when its position is a page's first."""
    token_ids, positions, active8, bt, st, new_pages = _decode_buffers(
        b_pad, w, sw, max_new_pages)
    cols = [np.fromiter((e[k] for e in entries), np.int32,
                        count=len(entries)) for k in range(3)]
    # the library writes row ``slot`` and reads the table at ``position``
    if len(entries) and not (0 <= cols[0].min() and cols[0].max() < b_pad
                             and cols[2].min() >= 0):
        raise ValueError(f"decode batch of {b_pad} rows: slots must lie in "
                         f"[0, {b_pad}) and positions be >= 0")
    tbl_flat, tbl_lens = _flat([e[3] for e in entries])
    stbl_flat, stbl_lens = _flat([e[4] for e in entries])
    n_new = get_lib().build_decode_batch(
        len(entries), page_size, *(_p32(c) for c in cols),
        _p32(tbl_flat), _p32(tbl_lens), _p32(stbl_flat), _p32(stbl_lens),
        w, sw, _p32(token_ids), _p32(positions),
        active8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), _p32(bt),
        _p32(st), _p32(new_pages), max_new_pages,
    )
    return (token_ids, positions, active8.astype(bool), bt, st, new_pages,
            int(n_new))


def build_decode_batch_plain(
    entries, page_size: int, b_pad: int, w: int, sw: int,
    max_new_pages: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, int]:
    """The numpy version of ``build_decode_batch``."""
    token_ids, positions, active8, bt, st, new_pages = _decode_buffers(
        b_pad, w, sw, max_new_pages)
    n_new = 0
    for slot, token, pos, tbl, stbl in entries:
        token_ids[slot] = token
        positions[slot] = pos
        active8[slot] = 1
        bt[slot, : min(len(tbl), w)] = tbl[:w]
        st[slot, : min(len(stbl), sw)] = stbl[:sw]
        if pos % page_size == 0 and n_new < max_new_pages:
            pg = pos // page_size
            if pg < len(tbl):
                new_pages[n_new] = tbl[pg]
                n_new += 1
    return (token_ids, positions, active8.astype(bool), bt, st, new_pages,
            n_new)
