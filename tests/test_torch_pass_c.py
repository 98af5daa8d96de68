"""Pass C's device route (uvc_tpu_torch/pileup/device_pass_c.py,
kernels/csrc/pass_c.cu, pileup/region_device.py).

On the CPU: the plain PyTorch version of the kernel (``scatter_plain``),
run on the route's staged and narrowed inputs (``stage``), held array for
array to the native pass (ops/native_rowpile.pass_c_native, the host
route's) and to the numpy pass (engine_bq.pass_c_scatter(...,
use_native=False)) on every region of the bench job, of golden_small,
golden_umi_duplex (UMI dflags) and golden_iontorrent, and on golden_small's
region made amplicon (dflag | 0x4), short-read (is_high_readlen 0), without
bm1500, and on a region with insertions and deletions.  The route itself:
taken on the family chain's device, also for duplex-flagged families; a
column outside its narrow range takes the native pass and leaves
``pass_c_device`` at 0; forced onto the CPU (its plain version) it keeps
golden_umi_duplex byte-identical.

On the card (``-m cuda``): the kernel on the same cases, the stream
synchronised after each launch, against the plain version (planes and
aDP4) and the native pass.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from uvc_tpu_torch import goldens
from uvc_tpu_torch.cli import uvc1
from uvc_tpu_torch.family import device_chain as dc
from uvc_tpu_torch.ops import native_rowpile
from uvc_tpu_torch.pileup import device_pass_c as dp
from uvc_tpu_torch.pileup import engine_bq
from uvc_tpu_torch.utils import profiling

WORKLOADS = ("bench", "golden_small", "golden_umi_duplex",
             "golden_iontorrent")
VARIANTS = ("amplicon", "short_read", "no_bm1500", "indels")


def capture(monkeypatch, argv, route=False):
    """The pass C arguments of every region of one uvc1 run, and the run's
    stats.  ``route``: let the route run its plain version on the CPU;
    else every region keeps the host route."""
    got = []
    real = dp.route

    def rec(*args):
        got.append(args)
        return real(*args)

    monkeypatch.setattr(dp, "route", rec)
    if route:
        monkeypatch.setattr(dc, "ROUTE_TYPES", ("cuda", "cpu"))
    stats = {}
    assert uvc1.run(argv, stats=stats) == 0
    monkeypatch.setattr(dp, "route", real)
    return got, stats


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pass_c")
    return str(d), goldens.build_inputs(str(d))


def _regions(d, args):
    """{workload: [pass C arguments]} of the bench job and the goldens
    (uvc1 on the CPU, the host route kept)."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in WORKLOADS[1:]:
            out[name], _ = capture(mp, args[name] + [
                "--device", "cpu", "-o", os.path.join(d, f"{name}.vcf.gz")])
        fa, bam = goldens.build_bench_input(d)
        out["bench"], _ = capture(mp, ["-f", fa, "-t", "1", bam, "--device",
                                       "cpu", "-o",
                                       os.path.join(d, "bench.vcf.gz")])
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def regions(inputs):
    return _regions(*inputs)


def variant(regions, name):
    """golden_small's region (or, for ``indels``, the first golden region
    with both insertion and deletion events) changed as ``name`` says."""
    if name == "indels":
        for w in WORKLOADS[1:]:
            for args in regions[w]:
                if {1, 2} <= set(np.unique(args[0].cigar_op).tolist()):
                    return args
        raise AssertionError("no golden region has insertions and deletions")
    allev, table, baq, baq2, thres, off, P, cfg, dflag = regions[
        "golden_small"][0]
    if name == "amplicon":
        dflag = dflag | 0x4
    elif name == "short_read":
        cfg = copy.copy(cfg)
        cfg.central_readlen = cfg.microadjust_median_readlen_thres - 1
    elif name == "no_bm1500":
        assert allev.bm1500 is not None
        allev = dataclasses.replace(allev, bm1500=None)
    return allev, table, baq, baq2, thres, off, P, cfg, dflag


def cases(regions, name):
    return regions[name] if name in WORKLOADS else [variant(regions, name)]


def planes_of(info, bg, a1, a2):
    """{name: array} of pass C's result."""
    d = {nm: getattr(info, nm) for nm in engine_bq.SegInfo.names}
    d.update(bg=bg, a1=a1, a2=a2)
    return d


def differences(want, got, dtypes=True):
    """The names of the planes in which two results differ (values, shape,
    and dtype unless ``dtypes`` is false)."""
    w, g = planes_of(*want), planes_of(*got)
    return [nm for nm in w if w[nm].shape != g[nm].shape
            or (dtypes and w[nm].dtype != g[nm].dtype)
            or not np.array_equal(w[nm], g[nm])]


def plain(args):
    """The route's plain version on ``args``: (its result as
    pass_c_scatter's, aDP4)."""
    st = dp.stage(*args)
    assert st is not None
    err, got = dp.scatter_plain(*st, dp.params(st[0], args[7]))
    assert err == 0
    out, big, adp4 = got
    return dp.host_planes(out.numpy(), big.numpy(), args[6]), adp4


def native_adp4(res):
    info = res[0]
    return (info.aDPff + info.aDPfr + info.aDPrf
            + info.aDPrr).reshape(-1).astype(np.int64)


@pytest.mark.parametrize("name", WORKLOADS + VARIANTS)
def test_plain_version_matches_the_native_and_numpy_passes(regions, name):
    cs = cases(regions, name)
    assert cs
    if name == "bench":
        assert len(cs) == 4 and all(len(a[0].pos) > 10**6 for a in cs)
    if name == "golden_umi_duplex":
        assert any(np.any(a[8] & 0x1) for a in cs)
    if name == "amplicon":
        assert not np.any(cases(regions, "golden_small")[0][8] & 0x4)
    for args in cs:
        native = engine_bq.pass_c_scatter(*args)
        got, adp4 = plain(args)
        assert differences(native, got) == []
        assert differences(engine_bq.pass_c_scatter(*args, use_native=False),
                           got, dtypes=False) == []
        assert torch.equal(adp4, torch.from_numpy(native_adp4(native)))


def _forced(monkeypatch):
    monkeypatch.setattr(dc, "ROUTE_TYPES", ("cuda", "cpu"))


@pytest.mark.parametrize("name", ["golden_small", "indels"])
def test_route_on_the_cpu_equals_the_native_pass(regions, monkeypatch,
                                                 name):
    args = cases(regions, name)[0]
    assert dp.route(*args).route == "host"
    _forced(monkeypatch)
    pc = dp.route(*args)
    assert pc.route == "device" and pc.run is None
    assert differences(engine_bq.pass_c_scatter(*args), dp.result(pc)) == []


@pytest.mark.parametrize("column", ["val", "indel_len", "reads"])
def test_a_column_outside_its_range_takes_the_native_pass(regions,
                                                          monkeypatch,
                                                          column):
    allev, table, *rest = cases(regions, "golden_small")[0]
    if column == "reads":
        r = dataclasses.replace(table.reads,
                                isize=table.reads.isize.astype(np.int64))
        r.isize[0] = 2**31
        table = dataclasses.replace(table, reads=r)
    else:
        col = getattr(allev, column).copy()
        col[0] = 2**31
        allev = dataclasses.replace(allev, **{column: col})
    args = (allev, table, *rest)
    assert dp.stage(*args) is None
    _forced(monkeypatch)
    pc = dp.route(*args)
    assert pc.route == "host"
    assert differences(engine_bq.pass_c_scatter(*args), dp.result(pc)) == []


def test_events_outside_the_planes_take_the_native_pass(regions,
                                                        monkeypatch):
    """An event past the region: the plain version flags it, and the
    native pass raises as it always has."""
    allev, *rest = cases(regions, "golden_small")[0]
    pos = allev.pos.copy()
    pos[0] = rest[5]
    args = (dataclasses.replace(allev, pos=pos), *rest)
    st = dp.stage(*args)
    assert dp.scatter_plain(*st, dp.params(st[0], rest[6]))[0] == dp.E_EVENTS
    _forced(monkeypatch)
    with pytest.raises(ValueError, match="outside"):
        dp.route(*args)


def _pileup_routes(stats):
    return {s["attrs"].get("route") for s in stats["spans"]
            if s["name"] == "prepare.pileup" and "route" in s["attrs"]}


def test_a_column_outside_its_range_leaves_the_count_at_zero(
        inputs, monkeypatch, tmp_path):
    """uvc1 with the route forced onto the CPU and an event column that
    int32 would wrap in every region: pass C on the host in every region,
    ``pass_c_device`` 0, every pass C span ``host``."""
    _, args = inputs
    real = engine_bq.compute_event_values

    def wide(*a, **kw):
        allev, gap_info = real(*a, **kw)
        val = allev.val.copy()
        val[-1] = 2**31
        return dataclasses.replace(allev, val=val), gap_info

    monkeypatch.setattr(engine_bq, "compute_event_values", wide)
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "trace"))
    _, stats = capture(monkeypatch, args["golden_small"] + [
        "--device", "cpu", "-o", str(tmp_path / "o.vcf.gz")], route=True)
    assert stats["regions"] >= 1 and stats["pass_c_device"] == 0
    assert _pileup_routes(stats) == {"host"}


def test_cpu_device_keeps_the_host_route(inputs, monkeypatch, tmp_path):
    _, args = inputs
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "trace"))
    stats = {}
    assert uvc1.run(args["golden_small"] + [
        "--device", "cpu", "-o", str(tmp_path / "o.vcf.gz")],
        stats=stats) == 0
    assert stats["pass_c_device"] == 0 and stats["regions"] >= 1
    assert _pileup_routes(stats) == {"host"}


def test_forced_route_keeps_the_duplex_golden(inputs, monkeypatch, tmp_path):
    """golden_umi_duplex (duplex-flagged: the family chain on the host)
    with the route on the CPU: pass C takes it in every region, and the
    body is byte-identical to the golden."""
    _, args = inputs
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "trace"))
    out = str(tmp_path / "o.vcf.gz")
    _, stats = capture(monkeypatch, args["golden_umi_duplex"] + [
        "--device", "cpu", "-o", out], route=True)
    assert stats["pass_c_device"] == stats["regions"] >= 1
    assert stats["families_device"] == 0
    assert _pileup_routes(stats) == {"device"}
    assert goldens.read_body(out) == goldens.golden("golden_umi_duplex")


def test_slots_and_params_follow_the_kernel_source():
    import re
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "uvc_tpu_torch", "kernels", "csrc",
            "pass_c.cu")) as fh:
        src = fh.read()

    def enum(name, prefix):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return [t.strip()[len(prefix):] for t in body.split(",")
                if t.strip().startswith(prefix) and "N_" not in t]

    assert [s.lower() for s in enum("Slot", "S_")] == [
        nm for nm, _, _ in dp.SLOTS]
    assert [s.lower() for s in enum("Param", "P_")] == [
        p.lower() for p in dp.PARAMS]
    assert enum("Plane", "O_") == list(native_rowpile.PLANES)
    assert enum("Big", "B_") == list(native_rowpile.BIG_PLANES)
    assert [int(v) for v in re.findall(
        r"F_\w+ = (\d+)", src)] == [dp.F_GAP, dp.F_INS, dp.F_FAR_INDEL]


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_regions(cuda, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pass_c_card"))
    return _regions(d, goldens.build_inputs(d))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS + VARIANTS)
def test_kernel_matches_plain_and_native_on_the_card(cuda, card_regions,
                                                     name):
    """The kernel's planes and aDP4 on the card, synchronised after each
    launch, entry for entry against the plain version's, and the route's
    result against the native pass."""
    for args in cases(card_regions, name):
        st = dp.stage(*args)
        err, (out, big, adp4) = dp.scatter_plain(*st,
                                                 dp.params(st[0], args[7]))
        assert err == 0
        run_ = dp.launch(*args, cuda, sync_each=True)
        run_["stream"].synchronize()
        got_out, got_big = dp.take(run_, dp.readback(run_))
        assert np.array_equal(got_out, out.numpy())
        assert np.array_equal(got_big, big.numpy())
        i = dp.SLOT["adp4"]
        o = run_["offs"][i]
        got_adp4 = run_["dev"][o:o + 8 * len(adp4)].view(torch.int64).cpu()
        assert torch.equal(got_adp4, adp4)
        got = dp.host_planes(got_out, got_big, args[6])
        assert differences(engine_bq.pass_c_scatter(*args), got) == []
