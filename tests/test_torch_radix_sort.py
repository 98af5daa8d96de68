"""dc_sort's radix sort (kernels/csrc/device_consensus.cu) built as host
C++ with g++ and held, with the Python plan (ops/device_consensus.sort_plan),
to the plain version ``dc_sort_plain`` on the CPU.

The source's HD helpers (digit extraction, pack, stable warp rank, the
staging and scatter offsets, gather) build for the host, and its host
driver runs the kernels' passes on one thread, warps and lanes in turn.
The tables: random, negative keys, INT32_MIN/INT32_MAX extremes, keys
wider than one 64-bit word, all-equal keys, many duplicates, N = 1024,
and the stage-1 and stage-2 tables of a real fragment stream.  The card
test in tests/test_torch_device_consensus.py sorts the same tables.
chip_smoke.py's library route of the sorts (``library_sort``: a stable
torch.sort of each packed 64-bit word, top bit flipped, then one gather),
its yardstick, is held to the same plain sort on the CPU.  Imports no JAX.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from uvc_tpu_torch.ops import device_consensus as tdc

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "uvc_tpu_torch", "kernels", "csrc")
I32 = np.iinfo(np.int32)

# the tables both the host test and the card test sort
SORT_TABLES = ("random_stage1", "random_stage2", "negative", "extremes",
               "wide", "all_equal", "duplicates", "n1024", "real_stage1",
               "real_stage2")


def _with_idx(keys, extra, rng):
    """A table of ``keys`` rows, an arange index row (so a stable order is
    checkable) and ``extra`` random payload rows."""
    N = keys.shape[1]
    pay = rng.integers(I32.min, I32.max, (extra, N), endpoint=True)
    return np.concatenate([keys, np.arange(N)[None], pay]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def real_stream():
    """(group, pos, sym, val) of the real fragment stream of
    test_torch_device_consensus.test_real_fragment_stream."""
    from uvc_tpu_torch.io import bam as bam_mod
    from uvc_tpu_torch.io import simulate
    from uvc_tpu_torch.pileup import events as ev_mod

    ref = simulate.random_ref(3000, 3)
    variants = [simulate.Variant(900, f"{ref[900]}>"
                                 + ("A" if ref[900] != "A" else "C"), 0.3),
                simulate.Variant(1500, "+CT", 0.3)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "d.bam")
        simulate.build_bam(path, ref, depth=60, variants=variants, seed=4)
        _, batch = bam_mod.read_bam(path)
    b = ev_mod.expand(batch).bases
    return (b.read.astype(np.int64) // 2, b.rpos.astype(np.int64),
            b.sym.astype(np.int64), b.bq.astype(np.int64))


def plain_stage_tables(cols, mode_sum, ovr, nkeys1, nkeys2):
    """The plain program's tables from event columns ``cols``: the stage-1
    table sorted on ``nkeys1`` keys, the stage-2 table dc_segments builds
    from it, and that table sorted on ``nkeys2`` keys."""
    buf1 = torch.from_numpy(tdc.stage1_table(*cols))
    N = buf1.shape[1]
    tdc.dc_sort_plain(buf1, nkeys1)
    out_u = torch.zeros((4, N), dtype=torch.int32)
    buf2 = torch.zeros((len(tdc.COLS2), N), dtype=torch.int32)
    tdc.dc_segments_plain(1, buf1, mode_sum, ovr, out_u, buf2,
                          torch.zeros(2, dtype=torch.int32))
    t2 = buf2.clone()
    tdc.dc_sort_plain(buf2, nkeys2)
    return buf1, t2, buf2


def sort_table(name):
    """(int32 table [A, N], nkeys) of one of SORT_TABLES."""
    rng = np.random.default_rng(SORT_TABLES.index(name))
    if name == "random_stage1":
        N = 8192
        keys = np.stack([rng.integers(0, 2, N), rng.integers(0, 300, N),
                         rng.integers(0, 3000, N), rng.integers(0, 14, N)])
        return _with_idx(keys, 1, rng), 4
    if name == "random_stage2":
        N = 16384
        keys = np.stack([rng.integers(0, 2, N), rng.integers(0, 200, N),
                         rng.integers(0, 3000, N), rng.integers(0, 2, N),
                         rng.integers(0, 2, N), -rng.integers(0, 120, N),
                         rng.integers(0, 14, N)])
        return _with_idx(keys, 1, rng), 7
    if name == "negative":
        N = 8192
        keys = np.stack([rng.integers(-3, 1, N), rng.integers(-5000, -100, N),
                         rng.integers(-(1 << 20), 1 << 20, N)])
        return _with_idx(keys, 2, rng), 3
    if name == "extremes":
        N = 4096
        vals = np.array([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                         I32.max])
        keys = vals[rng.integers(0, len(vals), (4, N))]
        return _with_idx(keys, 1, rng), 4
    if name == "wide":
        N = 8192
        keys = rng.integers(I32.min, I32.max, (7, N), endpoint=True)
        keys[0] = rng.integers(0, 2, N)
        return _with_idx(keys, 1, rng), 7
    if name == "all_equal":
        N = 4096
        keys = np.full((4, N), -7)
        return _with_idx(keys, 1, rng), 4
    if name == "duplicates":
        N = 32768
        keys = rng.integers(0, 2, (3, N))
        return _with_idx(keys, 2, rng), 3
    if name == "n1024":
        N = 1024
        keys = np.stack([rng.integers(0, 2, N), rng.integers(0, 50, N),
                         rng.integers(0, 500, N), rng.integers(0, 14, N)])
        return _with_idx(keys, 1, rng), 4
    cols = real_stream()
    if name == "real_stage1":
        return tdc.stage1_table(*cols), tdc.NKEYS1
    t2 = plain_stage_tables(cols, False, True, tdc.NKEYS1, tdc.NKEYS2)[1]
    return t2.numpy(), tdc.NKEYS2


_HOST_MAIN = '#include "%s"\n'


@pytest.fixture(scope="module")
def host_sort(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_radix")
    (d / "radix.cpp").write_text(
        _HOST_MAIN % os.path.join(CSRC, "device_consensus.cu"))
    r = subprocess.run([cxx, "-std=c++17", "-O2", "-Wall", "-fPIC",
                        "-shared", "-o", str(d / "radix.so"),
                        str(d / "radix.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "radix.so"))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.uvc_dc_sort_ranges_host.argtypes = [vp, ll, ci, vp]
    lib.uvc_dc_sort_ranges_host.restype = None
    lib.uvc_dc_sort_host.argtypes = [vp, ll, ci, ctypes.POINTER(ci), ci]
    lib.uvc_dc_sort_host.restype = ci
    lib.uvc_dc_sort_scratch.argtypes = [ll, ci]
    lib.uvc_dc_sort_scratch.restype = ll
    return lib


def _host_run(lib, table, nkeys):
    """(plan, table sorted by the host build) of ``table`` on ``nkeys``."""
    A, N = table.shape
    rng = np.zeros(2 * nkeys, dtype=np.uint32)
    lib.uvc_dc_sort_ranges_host(table.ctypes.data, N, nkeys, rng.ctypes.data)
    lo, hi = tdc.decode_ranges(rng)
    assert lo == table[:nkeys].min(axis=1).tolist()
    assert hi == table[:nkeys].max(axis=1).tolist()
    plan = tdc.sort_plan(lo, hi)
    got = np.ascontiguousarray(table.copy())
    ints = (ctypes.c_int * len(plan.ints))(*plan.ints)
    assert lib.uvc_dc_sort_host(got.ctypes.data, N, A, ints,
                                len(plan.ints)) == 0
    return plan, got


@pytest.mark.parametrize("name", SORT_TABLES)
def test_host_radix_sort_matches_plain(host_sort, name):
    """Host ranges -> Python plan -> host radix passes, against the stable
    plain sort of the same table: every entry equal."""
    table, nkeys = sort_table(name)
    plan, got = _host_run(host_sort, table, nkeys)
    want = torch.from_numpy(table.copy())
    tdc.dc_sort_plain(want, nkeys)
    np.testing.assert_array_equal(got, want.numpy())
    if name == "all_equal":
        assert plan.words == [] and plan.ints == [0]
    if name in ("extremes", "wide"):
        assert len(plan.words) > 1, str(plan)
    if name == "real_stage1":   # (inval, g, p, s) fit one word
        assert len(plan.words) == 1 and plan.widths[0] == 1, str(plan)


@pytest.mark.parametrize("name", SORT_TABLES)
def test_library_route_matches_plain(name):
    """chip_smoke.library_sort, on a CPU tensor, against the stable plain
    sort: every entry equal (the extremes and wide tables fill words to
    their top bit, which the route flips to sort unsigned words as
    int64)."""
    import chip_smoke
    table, nkeys = sort_table(name)
    got = torch.from_numpy(table.copy())
    chip_smoke.library_sort(got, nkeys)
    want = torch.from_numpy(table.copy())
    tdc.dc_sort_plain(want, nkeys)
    assert torch.equal(got, want)


def test_plan_packs_keys_whole_from_the_last():
    """Widths from int64 ranges, words filled from the last key, never a
    key split across words, zero-width keys skipped."""
    lo = [-2**31, 0, 5, -10, 3]
    hi = [2**31 - 1, 2**20 - 1, 5, 2**19, 3 + 2**29]
    plan = tdc.sort_plan(lo, hi)
    assert plan.widths == [32, 20, 0, 20, 30]
    # last key 4 (30 bits), then key 3 (20: 50), key 1 (20: 70 > 64 -> new)
    assert plan.words == [[(4, 0, 3), (3, 30, -10)],
                          [(1, 0, 0), (0, 20, -2**31)]]
    assert plan.bits == [50, 52] and plan.digits == [7, 7]
    assert plan.ints == [2, 2, 7, 4, 0, 3, 3, 30, -10,
                         2, 7, 1, 0, 0, 0, 20, -2**31]
    assert tdc.sort_plan([0, 0], [0, 0]).ints == [0]
    full = tdc.sort_plan([-2**31] * 3, [2**31 - 1] * 3)
    assert [len(w) for w in full.words] == [2, 1]
    assert full.digits == [8, 4]


def test_decode_ranges_round_trips_int32_extremes():
    vals = np.array([I32.min, -1, 0, I32.max], dtype=np.int64)
    for lo in vals:
        for hi in vals[vals >= lo]:
            ordl = (int(lo) + 2**31) & 0xFFFFFFFF
            ordh = (int(hi) + 2**31) & 0xFFFFFFFF
            raw = np.array([ordl, 0xFFFFFFFF - ordh], dtype=np.uint32)
            assert tdc.decode_ranges(raw.view(np.int32)) == ([lo], [hi])


def test_host_build_rejects_bad_plans(host_sort):
    table, nkeys = sort_table("n1024")
    A, N = table.shape
    before = table.copy()
    for bad in ([1], [1, 1, 1, A, 0, 0], [1, 1, 9, 0, 0, 0],
                [1, 1, 1, 0, 64, 0], [10], [1, 0, 1], [0, 5]):
        ints = (ctypes.c_int * len(bad))(*bad)
        assert host_sort.uvc_dc_sort_host(table.ctypes.data, N, A, ints,
                                          len(bad)) == -1, bad
    np.testing.assert_array_equal(table, before)
    assert host_sort.uvc_dc_sort_scratch(N, A) == (
        N * 24 + 4 * 256 * (1 + 72) + 4 * A * N)
