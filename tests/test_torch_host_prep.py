"""The port's host-prep library (``omniserve_tpu_torch/csrc/host_prep.cc``)
against its numpy versions and the JAX package's ``csrc`` entry points,
byte for byte, on seeded ragged tables (mirrors ``tests/test_host_prep.py``)."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from omniserve_tpu import csrc as j_csrc
from omniserve_tpu_torch import csrc
from omniserve_tpu_torch.csrc import build


def ragged_entries(seed, n, b_pad, page=128):
    rng = np.random.default_rng(seed)
    slots = rng.permutation(b_pad)[:n]
    entries = []
    for slot in slots:
        tbl = rng.integers(0, 1000, size=int(rng.integers(1, 9))).tolist()
        stbl = rng.integers(0, 1000, size=int(rng.integers(1, 4))).tolist()
        # positions on and off page starts, within the table
        pos = int(rng.integers(0, len(tbl))) * page + int(
            rng.choice([0, 0, 1, page - 1]))
        entries.append((int(slot), int(rng.integers(0, 128256)), pos, tbl,
                        stbl))
    return entries


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        else:
            assert x == y


def test_library_builds_and_is_keyed_by_source():
    lib = csrc.get_lib()
    assert lib is csrc.get_lib()
    path = build._target(csrc.HOST_PREP)
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")
    assert lib._name == path
    assert build.build_all([csrc.HOST_PREP]) >= 0     # built: a no-op


@pytest.mark.parametrize("width,fill", [(4, -1), (8, 0), (1, 7)])
def test_pad_block_tables_matches_plain_and_jax(width, fill):
    rng = np.random.default_rng(width)
    tables = [rng.integers(0, 500, size=int(rng.integers(0, 10))).tolist()
              for _ in range(13)] + [[]]
    got = csrc.pad_block_tables(tables, width, fill)
    assert_same([got], [csrc.pad_block_tables_plain(tables, width, fill)])
    assert_same([got], [j_csrc.pad_block_tables(tables, width, fill)])
    fixed = csrc.pad_block_tables([[1, 2, 3], [7], [], [4, 5, 6, 8, 9]],
                                  width=4, fill=-1)
    np.testing.assert_array_equal(fixed, np.array(
        [[1, 2, 3, -1], [7, -1, -1, -1], [-1] * 4, [4, 5, 6, 8]], np.int32))


@pytest.mark.parametrize("seed,n,b_pad,w,sw,max_new", [
    (0, 12, 16, 8, 4, 8),     # tables cut at w and sw
    (1, 128, 128, 6, 3, 128),
    (2, 5, 8, 16, 2, 2),      # more fresh pages than max_new
    (3, 0, 8, 4, 1, 1),       # no running sequence
])
def test_build_decode_batch_matches_plain_and_jax(seed, n, b_pad, w, sw,
                                                  max_new):
    entries = ragged_entries(seed, n, b_pad)
    args = dict(page_size=128, b_pad=b_pad, w=w, sw=sw,
                max_new_pages=max_new)
    got = csrc.build_decode_batch(entries, **args)
    assert_same(got, csrc.build_decode_batch_plain(entries, **args))
    assert_same(got, j_csrc.build_decode_batch(entries, **args))
    if n:
        assert got[6] > 0 or all(e[2] % 128 for e in entries)


@pytest.mark.parametrize("slot,pos", [(8, 0), (-1, 0), (0, -128)])
def test_build_decode_batch_refuses_rows_outside_the_batch(slot, pos):
    with pytest.raises(ValueError, match="slots must lie"):
        csrc.build_decode_batch([(slot, 1, pos, [3], [0])], page_size=128,
                                b_pad=8, w=2, sw=1, max_new_pages=1)


def test_concurrent_builds_load(tmp_path, monkeypatch):
    """Two processes build into one empty directory at once; each loads
    the library it finds and runs it."""
    code = textwrap.dedent(f"""
        from omniserve_tpu_torch import csrc
        from omniserve_tpu_torch.csrc import build
        build.BUILD_DIR = {str(tmp_path)!r}
        out = csrc.pad_block_tables([[1, 2], [3]], 3, -1)
        assert out.tolist() == [[1, 2, -1], [3, -1, -1]], out
        print(csrc.get_lib()._name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    assert paths == {build._target(csrc.HOST_PREP)}
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        paths.pop().rsplit("/", 1)[1]]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "host_prep.cc"
    bad.write_text("int build_decode_batch( {\n")
    monkeypatch.setattr(build, "_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError,
                       match=r"(?s)host_prep\.cc \(g\+\+ exit \d+\).*error"):
        csrc.get_lib()
    assert not any((tmp_path / "_build").iterdir())
