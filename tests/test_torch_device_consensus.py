"""The port's B1, the on-device fragment consensus
(uvc_tpu_torch/ops/device_consensus.py), against uvc_tpu's jitted program
(uvc_tpu.ops.device_consensus), row for row.

On the CPU the wrappers run their plain PyTorch versions: random tables
(mode max/sum x link_m_overridden x 2 seeds), the empty and one-row
tables, and the real fragment stream of tests/test_device_consensus.py.
The plain sorts on the JAX program's keys give the tables that an index
key would.  The port's uvc1 with UVC_TPU_DEVICE_PREPARE=1 writes the same
VCF body as without it.  On a card (marker ``cuda``) dc_sort and
dc_segments are held to their plain versions, dc_sort also on the edge
tables of tests/test_torch_radix_sort.py, dc_segments on those of
tests/test_torch_segments.py.  ``DEVICE`` is the card by
default, so a module fixture sets it to the CPU here, and a fresh process
shows the default.  JAX is imported inside the CPU tests, so the card-only
tests also run on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_device_consensus.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_radix_sort import (SORT_TABLES, plain_stage_tables,
                                   real_stream, sort_table)
from test_torch_segments import SEGMENT_TABLES, plain_stages, segment_case
from uvc_tpu_torch import kernels
from uvc_tpu_torch.ops import device_consensus as tdc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    """B1 runs on the card by default; these tests ask for the CPU."""
    prev = tdc.DEVICE
    tdc.DEVICE = torch.device("cpu")
    yield
    tdc.DEVICE = prev


_DEFAULT_DEVICE = """
import numpy as np
import torch
from uvc_tpu_torch import kernels
from uvc_tpu_torch.ops import device_consensus as tdc
z = np.arange(8)
try:
    tdc.device_reduce_consensus(z, z, z % 14, z, 16, "max", False)
    print("ran on", tdc.DEVICE, dict(kernels.LAUNCHES))
except RuntimeError as e:
    print("raised:", e)
print("calls:", tdc.STATS["calls"])
"""


def test_default_device_is_the_card():
    """Called without a device (a fresh process), device_reduce_consensus
    runs on CUDA: without a card it raises and runs nothing on the CPU."""
    r = subprocess.run([sys.executable, "-c", _DEFAULT_DEVICE],
                       env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    if torch.cuda.is_available():
        assert "ran on cuda" in r.stdout and "'dc_sort': 2" in r.stdout
    else:
        assert "raised: device_reduce_consensus: DEVICE is a CUDA device" \
            in r.stdout and "calls: 0" in r.stdout, r.stdout


def _check(group, pos, sym, val, P, mode, ovr):
    from uvc_tpu.ops import device_consensus as jdc
    want = jdc.device_reduce_consensus(group, pos, sym, val, P, mode, ovr)
    got = tdc.device_reduce_consensus(group, pos, sym, val, P, mode, ovr)
    names = ("ug", "up", "us", "uv", "group", "pos", "st", "con_sym",
             "con_cnt", "tot")
    for a, b, nm in zip(want[0] + want[1], got[0] + got[1], names):
        assert b.dtype == np.int64, nm
        np.testing.assert_array_equal(b, a, err_msg=nm)


def _random_table(seed, n=5000, P=300, G=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, G, n), rng.integers(0, P, n),
            rng.integers(0, 14, n), rng.integers(0, 60, n), P)


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("ovr", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_tables(mode, ovr, seed):
    _check(*_random_table(seed), mode, ovr)


def test_empty_and_one_row():
    z = np.zeros(0, dtype=np.int64)
    _check(z, z, z, z, 16, "max", False)
    _check(np.array([0]), np.array([3]), np.array([6]), np.array([9]),
           16, "sum", True)


def test_real_fragment_stream(tmp_path):
    from uvc_tpu_torch.io import bam as bam_mod
    from uvc_tpu_torch.io import simulate
    from uvc_tpu_torch.pileup import events as ev_mod

    ref = simulate.random_ref(3000, 3)
    variants = [simulate.Variant(900, f"{ref[900]}>"
                                 + ("A" if ref[900] != "A" else "C"), 0.3),
                simulate.Variant(1500, "+CT", 0.3)]
    path = str(tmp_path / "d.bam")
    simulate.build_bam(path, ref, depth=60, variants=variants, seed=4)
    _, batch = bam_mod.read_bam(path)
    b = ev_mod.expand(batch).bases
    group = b.read.astype(np.int64) // 2
    assert len(group) > 50000
    cols = (group, b.rpos.astype(np.int64), b.sym.astype(np.int64),
            b.bq.astype(np.int64), 3000)
    _check(*cols, "max", True)
    _check(*cols, "sum", False)


@pytest.mark.parametrize("stream", ["random0", "random1", "real"])
def test_jax_num_keys_give_the_same_tables(stream):
    """Sorting stably on the JAX program's keys (num_keys 4 and 7) gives
    the same stage-1 and stage-2 tables as sorting with idx, the row's
    position, as a last key (5 and 8 keys)."""
    cols = (real_stream() if stream == "real"
            else _random_table(int(stream[-1]))[:4])
    for mode_sum, ovr in ((False, True), (True, False)):
        jax_keys = plain_stage_tables(cols, mode_sum, ovr, 4, 7)
        total = plain_stage_tables(cols, mode_sum, ovr, 5, 8)
        assert (tdc.NKEYS1, tdc.NKEYS2) == (4, 7)
        for a, b in zip(jax_keys, total):
            assert torch.equal(a, b)


def test_uvc1_device_prepare_gate(tmp_path, monkeypatch):
    """UVC_TPU_DEVICE_PREPARE=1 routes the fragment consensus of the
    port's uvc1 through ops/device_consensus and gives a byte-identical
    VCF body."""
    from uvc_tpu_torch.io import simulate
    from uvc_tpu_torch import goldens
    from uvc_tpu_torch.cli import uvc1

    ref = simulate.random_ref(4000, 5)
    variants = [simulate.Variant(p, f"{ref[p]}>"
                                 + ("A" if ref[p] != "A" else "C"), 0.3)
                for p in range(500, 3500, 700)]
    bam = str(tmp_path / "t.bam")
    simulate.build_bam(bam, ref, depth=40, variants=variants, seed=3)
    fa = str(tmp_path / "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    args = ["-f", fa, "-t", "1", bam, "--device", "cpu", "--model-regime",
            "f64"]
    monkeypatch.delenv("UVC_TPU_DEVICE_PREPARE", raising=False)
    off = str(tmp_path / "off.vcf.gz")
    assert uvc1.run(args + ["-o", off]) == 0
    monkeypatch.setenv("UVC_TPU_DEVICE_PREPARE", "1")
    calls0 = tdc.STATS["calls"]
    on = str(tmp_path / "on.vcf.gz")
    assert uvc1.run(args + ["-o", on]) == 0
    assert tdc.STATS["calls"] > calls0, "the gate did not engage B1"
    body = goldens.read_body(on)
    assert any(not l.startswith("#") for l in body)
    assert body == goldens.read_body(off)


def test_concurrent_calls_are_serialized():
    """The CLI's worker threads call in concurrently: with more threads
    than cores and a short switch interval, every call gives its serial
    result and STATS counts every call and row."""
    import sys
    import threading
    tables = [_random_table(s, n=700 + 37 * s) for s in range(8)]
    want = [tdc.device_reduce_consensus(*t, "max", True) for t in tables]
    calls0, rows0 = tdc.STATS["calls"], tdc.STATS["rows"]
    got = [[None] * 8 for _ in range(16)]

    def work(w):
        for i, t in enumerate(tables):
            got[w][i] = tdc.device_reduce_consensus(*t, "max", True)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert tdc.STATS["calls"] - calls0 == 16 * 8
    assert tdc.STATS["rows"] - rows0 == 16 * sum(len(t[0]) for t in tables)
    for row in got:
        for w, g in zip(want, row):
            for a, b in zip(w[0] + w[1], g[0] + g[1]):
                np.testing.assert_array_equal(b, a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("ovr", [False, True])
def test_kernels_match_plain_on_card(cuda, mode, ovr):
    """dc_sort and dc_segments against their plain versions, each from
    the same input table, both stages; every entry equal."""
    table = torch.from_numpy(tdc.stage1_table(*_random_table(2)[:4]))
    N = table.shape[1]
    kernels.reset_launches()
    outs = {}
    for dev in ("cpu", cuda):
        kw = dict(dtype=torch.int32, device=dev)
        buf1 = table.clone().to(dev)
        out_u, out_c = torch.zeros((4, N), **kw), torch.zeros((6, N), **kw)
        buf2, counts = torch.empty((9, N), **kw), torch.zeros(2, **kw)
        # snapshots are copies: the sorts work in place
        tdc.dc_sort(buf1, tdc.NKEYS1)
        s1 = buf1.cpu().clone()
        tdc.dc_segments(1, buf1, mode == "sum", ovr, out_u, buf2, counts)
        t2 = buf2.cpu().clone()
        tdc.dc_sort(buf2, tdc.NKEYS2)
        s2 = buf2.cpu().clone()
        tdc.dc_segments(2, buf2, mode == "sum", ovr, out_c, None, counts)
        outs[str(dev)] = [s1, t2, s2, out_u.cpu(), out_c.cpu(), counts.cpu()]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["dc_sort"] == kernels.LAUNCHES["dc_segments"] == 2
    # the host radix test's edge tables (multi-word keys, extremes, all
    # equal, duplicates, N = 1024, the real stream's two stages)
    for name in SORT_TABLES:
        table, nkeys = sort_table(name)
        want = torch.from_numpy(table.copy())
        tdc.dc_sort_plain(want, nkeys)
        got = torch.from_numpy(table).to(cuda)
        plan = tdc.dc_sort(got, nkeys)
        assert torch.equal(got.cpu(), want), (name, str(plan))
    # the host segment test's edge tables (one segment across every tile,
    # segments and groups starting at a tile's last row, no valid row,
    # int32 extremes, rows marked invalid inside the valid range, ...),
    # stage 2 on stage 1's scratch as the program runs it (above, each
    # stage zeroed its own)
    for name in SEGMENT_TABLES:
        buf1, mode_sum, ovr = segment_case(name)
        want = plain_stages(buf1, mode_sum, ovr)
        N = buf1.shape[1]
        kw = dict(dtype=torch.int32, device=cuda)
        out_u, out_c = torch.zeros((4, N), **kw), torch.zeros((6, N), **kw)
        buf2, counts = torch.empty((9, N), **kw), torch.zeros(2, **kw)
        scratch = tdc.dc_segments(1, buf1.to(cuda), mode_sum, ovr, out_u,
                                  buf2, counts)
        tdc.dc_segments(2, want[2].to(cuda), mode_sum, ovr, out_c, None,
                        counts, scratch)
        for a, b in zip(want[:2] + want[3:], (out_u, buf2, out_c, counts)):
            assert torch.equal(a, b.cpu()), name
