"""dc_segments' tile passes (kernels/csrc/device_consensus.cu) built as host
C++ with g++ and held to the plain version ``dc_segments_plain`` on the
CPU, entry for entry: both stages' outputs, the counts and the whole
stage-2 table.

The source's HD helpers (a thread's start and end flags, the segmented
suffix reduce and its join, the output rows) build for the host, and its
host driver runs a stage's tiles in order on one thread: a tile's threads
in turn, the walk of a segment past the tile's end, the look-back as a
running prefix.  Each table runs at the card's tile and at a tile of 64
rows, so that a 1,024-row table crosses many tiles.  The card test in
tests/test_torch_device_consensus.py runs the same tables through the
kernels.  chip_smoke.b1_bounds counts the columns each stage must move.
Imports no JAX.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_radix_sort import CSRC, _HOST_MAIN, real_stream
from uvc_tpu_torch.ops import device_consensus as tdc

I32 = np.iinfo(np.int32)

# the tables: event columns through the plain stage-1 sort, or (inval_*)
# a sorted table edited after the sort
SEGMENT_TABLES = ("random_max", "random_max_ovr", "random_sum",
                  "random_sum_ovr", "wide", "all_equal", "all_distinct",
                  "start_at_tile_end", "group_at_tile_end", "no_valid_row",
                  "n1024", "int32_extremes_sum", "int32_extremes_max",
                  "inval_inside", "real_max_ovr", "real_sum")


def card_tile():
    """SEG_THREADS * SEG_ITEMS, the kernel's tile, from the source."""
    with open(os.path.join(CSRC, "device_consensus.cu")) as fh:
        src = fh.read()
    get = (lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                      src).group(1)))
    return get("SEG_THREADS") * get("SEG_ITEMS")


def segment_case(name):
    """(sorted stage-1 table [6, N] int32, mode_sum, ovr) of one of
    SEGMENT_TABLES."""
    rng = np.random.default_rng(100 + SEGMENT_TABLES.index(name))
    mode_sum = "sum" in name
    ovr = "ovr" in name
    if name.startswith("random"):
        n = 6000
        cols = (rng.integers(0, 40, n), rng.integers(0, 300, n),
                rng.integers(0, 14, n), rng.integers(0, 60, n))
    elif name == "wide":
        n = 5000
        cols = (rng.integers(I32.min, I32.max, n, endpoint=True),
                rng.integers(I32.min, I32.max, n, endpoint=True),
                rng.integers(0, 14, n), rng.integers(-60, 60, n))
        mode_sum, ovr = True, True
    elif name == "all_equal":       # one segment across every tile
        n = 4096
        cols = (np.full(n, 3), np.full(n, 77), np.full(n, 7),
                rng.integers(0, 60, n))
        mode_sum, ovr = True, True
    elif name == "all_distinct":    # every row its own segment
        n = 4096
        cols = (np.zeros(n, np.int64), np.arange(n), rng.integers(0, 14, n),
                rng.integers(1, 60, n))
    elif name == "start_at_tile_end":
        # stage-1 segments of two rows, each starting at an odd row: one
        # starts at every tile's last row and ends in the next tile
        n = 8192
        cols = (np.zeros(n, np.int64), (np.arange(n) + 1) // 2,
                np.full(n, 3), rng.integers(-5, 60, n))
        mode_sum = True
    elif name == "group_at_tile_end":
        # unique rows in pairs of (g, p, st) starting at odd rows: stage-2
        # groups that start at a tile's last row
        n = 8192
        cols = (np.zeros(n, np.int64), (np.arange(n) + 1) // 2,
                np.arange(n) % 2, rng.integers(1, 60, n))
        ovr = True
    elif name == "no_valid_row":
        cols = tuple(np.zeros(0, np.int64) for _ in range(4))
    elif name == "n1024":
        n = 1000
        cols = (rng.integers(0, 20, n), rng.integers(0, 40, n),
                rng.integers(0, 14, n), rng.integers(0, 60, n))
        mode_sum, ovr = True, True
    elif name.startswith("int32_extremes"):   # wrapping sums and -v
        n = 3000
        vals = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                         I32.max])
        cols = (rng.integers(0, 3, n), rng.integers(0, 20, n),
                rng.integers(0, 14, n), vals[rng.integers(0, len(vals), n)])
        ovr = True
    elif name == "inval_inside":
        n = 6000
        cols = (rng.integers(0, 40, n), rng.integers(0, 300, n),
                rng.integers(0, 14, n), rng.integers(0, 60, n))
        mode_sum = True
    else:
        cols = real_stream()
        mode_sum, ovr = name == "real_sum", name == "real_max_ovr"
    buf = torch.from_numpy(tdc.stage1_table(*cols))
    tdc.dc_sort_plain(buf, tdc.NKEYS1)
    if name == "inval_inside":
        # rows marked invalid inside the valid range: no sort leaves them
        # there, but the passes must take them as the plain version does
        buf[0, rng.choice(n, 200, replace=False)] = 1
    return buf, mode_sum, ovr


def plain_stages(buf1, mode_sum, ovr):
    """The plain version's stage 1 on ``buf1``, the plain sort of its
    stage-2 table and stage 2 on that: (out_u, buf2, sorted buf2, out_c,
    counts)."""
    N = buf1.shape[1]
    out_u = torch.zeros((4, N), dtype=torch.int32)
    out_c = torch.zeros((6, N), dtype=torch.int32)
    buf2 = torch.zeros((len(tdc.COLS2), N), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    tdc.dc_segments_plain(1, buf1, mode_sum, ovr, out_u, buf2, counts)
    s2 = buf2.clone()
    tdc.dc_sort_plain(s2, tdc.NKEYS2)
    tdc.dc_segments_plain(2, s2, mode_sum, ovr, out_c, None, counts)
    return out_u, buf2, s2, out_c, counts


@pytest.fixture(scope="module")
def host_segments(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_segments")
    (d / "seg.cpp").write_text(
        _HOST_MAIN % os.path.join(CSRC, "device_consensus.cu"))
    r = subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-fPIC",
                        "-shared", "-o", str(d / "seg.so"),
                        str(d / "seg.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "seg.so"))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.uvc_dc_segments_host.argtypes = [ci, vp, ll, ci, ci, ci, vp, vp, vp]
    lib.uvc_dc_segments_host.restype = ci
    lib.uvc_dc_segments_scratch.argtypes = [ll]
    lib.uvc_dc_segments_scratch.restype = ll
    return lib


def _host_stage(lib, stage, buf, mode_sum, ovr, tile, counts):
    """One stage of the host build on ``buf``: (out, buf2 or None)."""
    N = buf.shape[1]
    buf = np.ascontiguousarray(buf.numpy())
    out = np.zeros((4 if stage == 1 else 6, N), dtype=np.int32)
    # buf2 starts as garbage: stage 1 must write every entry
    buf2 = np.full((len(tdc.COLS2), N), -12345, dtype=np.int32)
    assert lib.uvc_dc_segments_host(
        stage, buf.ctypes.data, N, int(mode_sum), int(ovr), tile,
        out.ctypes.data, buf2.ctypes.data if stage == 1 else None,
        counts.ctypes.data) == 0
    return torch.from_numpy(out), torch.from_numpy(buf2)


@pytest.mark.parametrize("tile", ["card", 64])
@pytest.mark.parametrize("name", SEGMENT_TABLES)
def test_host_segments_match_plain(host_segments, name, tile):
    """Host tile passes, both stages, against the plain version: out_u,
    the whole stage-2 table, out_c and both counts, every entry equal."""
    tile = card_tile() if tile == "card" else tile
    buf1, mode_sum, ovr = segment_case(name)
    out_u, buf2, s2, out_c, counts = plain_stages(buf1, mode_sum, ovr)
    got_counts = np.zeros(2, dtype=np.int32)
    got_u, got_b2 = _host_stage(host_segments, 1, buf1, mode_sum, ovr, tile,
                                got_counts)
    got_c, _ = _host_stage(host_segments, 2, s2, mode_sum, ovr, tile,
                           got_counts)
    assert got_counts.tolist() == counts.tolist()
    assert torch.equal(got_u, out_u)
    assert torch.equal(got_b2, buf2)
    assert torch.equal(got_c, out_c)
    n_uniq, n_grp = counts.tolist()
    N = buf1.shape[1]
    if name == "all_equal":
        assert n_uniq == n_grp == 1 and N // tile > 1
    if name == "start_at_tile_end":
        assert (np.diff(got_u[1, :n_uniq].numpy()) == 1).all()
    if name == "group_at_tile_end":
        assert n_grp < n_uniq
    if name == "no_valid_row":
        assert n_uniq == n_grp == 0 and N == 1024
    if name.startswith("int32_extremes"):
        assert n_uniq < int((buf1[0] == 0).sum())    # segments of 2+ rows


def test_host_segments_reject_bad_arguments(host_segments):
    buf, _, _ = segment_case("n1024")
    a = np.ascontiguousarray(buf.numpy())
    out = np.zeros((6, 1024), dtype=np.int32)
    buf2 = np.zeros((9, 1024), dtype=np.int32)
    counts = np.zeros(2, dtype=np.int32)
    # no stage 3; N not a multiple of 1,024; tiles not a multiple of a
    # thread's rows
    for stage, N, tile in ((3, 1024, 64), (1, 1000, 64), (1, 1024, 2),
                           (2, 1024, 62)):
        assert host_segments.uvc_dc_segments_host(
            stage, a.ctypes.data, N, 0, 0, tile, out.ctypes.data,
            buf2.ctypes.data, counts.ctypes.data) == -1
    # the call's scratch, a half a stage: the tile counter and one status
    # word a tile
    tile = card_tile()
    for N in (1024, tile, 1 << 22):
        assert host_segments.uvc_dc_segments_scratch(N) == \
            2 * (8 + 8 * -(-N // tile))


def test_b1_bounds_count_the_columns_each_stage_moves():
    """dc_segments: stage 1 reads inval (N) and g, p, s, v of its ok rows
    (4 n_rows), and writes the unique rows (4 n_uniq) and the stage-2
    table (9 N); stage 2 reads c_inv (N) and g, p, st, s, v of its ok rows
    (5 n_pos) and writes 6 n_grp.  dc_sort reads and writes both
    tables."""
    import chip_smoke
    from uvc_tpu_torch.kernels.bounds import HBM_BYTES_PER_S
    N, nr, nu, npos, ng = 1 << 22, 2_699_037, 2_600_000, 2_500_003, 1_500_001
    b = chip_smoke.b1_bounds(N, nr, nu, npos, ng)
    assert b["dc_segments"][2] == 4 * (11 * N + 4 * nr + 4 * nu + 5 * npos
                                       + 6 * ng)
    # every row ok and every unique row with v > 0: every column of both
    # tables read
    full = chip_smoke.b1_bounds(N, N, nu, nu, ng)["dc_segments"][2]
    assert full == 4 * (15 * N + 9 * nu + 6 * ng)
    assert b["dc_sort"][2] == 2 * 4 * N * (6 + 9)
    for fam, (ms, by, nbytes) in b.items():
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3)
