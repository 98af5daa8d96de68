"""The family chain's device route (uvc_tpu_torch/family/device_chain.py,
kernels/csrc/family_chain.cu, pileup/region_device.py).

On the CPU: the plain PyTorch versions of the three kernels (the fragment
merge with pass D, the family merge with sweep 1, sweep 2), run as the
route runs them, held array for array to the host route's native chain
(ops/native_rowpile.frag_cons_with_pass_d, then fam_chain_statics) on the
regions of golden_small, golden_iontorrent (pdel_ign on), the bench job,
golden_tn's normal leg (rescue_add 4) and on single-strand UMI families
of 1-8 fragments made from golden_small's fragments; every plane, both
hists, fbeg/fend and the good, m2, mut and win rows in order.  The route
itself: taken with a card's device, never with ``--device cpu``, never
for duplex-flagged families or the consensus FASTQ; forced onto the CPU
(its plain versions) it keeps the goldens byte-identical.

The host steps around the route (``test_host_steps_follow_their_copies``):
region_device.call_region is region.py's call_region but for the routed
block and the result, region_device._host_chain is region.py's second
``prepare.families`` block, and device_chain.fq_result's tail is
engine_fq._run_fq_statics', statement for statement (comments aside).

On the card (``-m cuda``): each kernel against its plain version on the
bench job's regions and on the three UMI variants of golden_small's region
(the family merge's k-way path), the stream synchronised after each
launch, then the route's arrays against the plain and native chains.
"""

import ast
import dataclasses
import inspect
import os
import re
import textwrap

import numpy as np
import pytest
import torch

from uvc_tpu_torch import goldens
from uvc_tpu_torch.cli import uvc1, uvctn
from uvc_tpu_torch.family import device_chain as dc
from uvc_tpu_torch.family import engine_fq
from uvc_tpu_torch.pileup import region, region_device
from uvc_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def capture(monkeypatch, argv, tn=False, route=False):
    """The ChainInput of every region of one CLI run (``tn``: uvctn, else
    uvc1), and the run's stats.  ``route``: let the route run its plain
    versions on the CPU; else each region records its input and keeps
    the host route."""
    got = []
    real = dc.run

    def rec(ci, device, pass_c=None):
        got.append(ci)
        return real(ci, device, pass_c) if route else None

    monkeypatch.setattr(dc, "run", rec)
    monkeypatch.setattr(dc, "ROUTE_TYPES", ("cuda", "cpu"))
    stats = {}
    run = uvctn.run if tn else uvc1.run
    assert run(argv, stats=stats) == 0
    monkeypatch.setattr(dc, "run", real)
    return got, stats


def assert_same(want, got):
    """Array for array, dtypes included."""
    assert want is not None and got is not None
    assert dc.differences(want, got) == []


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("family_chain")
    return str(d), goldens.build_inputs(str(d))


@pytest.fixture(scope="module")
def regions(inputs):
    """{workload: [ChainInput]}: the goldens' regions, golden_tn's normal
    leg's and the bench job's."""
    d, args = inputs
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name in ("golden_small", "golden_iontorrent"):
            out[name], _ = capture(mp, args[name] + [
                "--device", "cpu", "-o", os.path.join(d, f"{name}.vcf.gz")])
        got, _ = capture(mp, goldens.build_tn_inputs(d)
                         + ["--device", "cpu"], tn=True)
        out["tn_normal"] = [ci for ci in got if ci.prm["rescue_add"] == 4]
        fa, bam = goldens.build_bench_input(d)
        out["bench"], _ = capture(mp, ["-f", fa, "-t", "1", bam, "--device",
                                       "cpu", "-o",
                                       os.path.join(d, "bench.vcf.gz")])
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["golden_small", "golden_iontorrent",
                                  "tn_normal", "bench"])
def test_plain_versions_match_the_native_chain(regions, name):
    cis = regions[name]
    assert cis
    if name == "golden_iontorrent":
        assert all(ci.prm["pdel_ign"] == 1 for ci in cis)
    if name == "bench":
        assert len(cis) == 4 and all(len(ci.pos) > 10**6 for ci in cis)
    for ci in cis:
        assert_same(dc.native_chain(ci), dc.run(ci, CPU))


@pytest.mark.parametrize("variant", dc.UMI_VARIANTS)
def test_plain_versions_match_on_umi_families(regions, variant):
    """golden_small's fragments grouped into single-strand UMI families
    of 1-8 fragments (device_chain.umi_variant): the k-way family merge;
    with rescue_add 4; and with fam_flag 0x2 (good rows without UMIs)."""
    ci = dc.umi_variant(regions["golden_small"][0], variant)
    want = dc.native_chain(ci)
    assert np.bincount(ci.fam_of_frag).max() > 1 and len(want.good[0]) > 0
    assert_same(want, dc.run(ci, CPU))


def test_inputs_the_host_leaves_its_path_on_take_the_host_route(regions):
    """Events out of read-major key order, and a fragment of more than 8
    reads: the native chain leaves its statics path, and the route hands
    the region back (None)."""
    ci = regions["golden_small"][0]
    pos = ci.pos.copy()
    pos[[0, 1]] = pos[[1, 0]]
    unsorted = dataclasses.replace(ci, pos=pos)
    assert dc.native_chain(unsorted) is None
    assert dc.run(unsorted, CPU) is None
    fr = ci.frag_of_read.copy()
    fr[:9] = fr[0]
    crowded = dataclasses.replace(ci, frag_of_read=fr)
    assert dc.native_chain(crowded) is None
    assert dc.run(crowded, CPU) is None


def _routes(stats):
    return {s["attrs"].get("route") for s in stats["spans"]
            if s["name"] == "prepare.families"}


def test_cpu_device_keeps_the_host_route(inputs, monkeypatch, tmp_path):
    _, args = inputs
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "trace"))
    stats = {}
    assert uvc1.run(args["golden_small"] + [
        "--device", "cpu", "-o", str(tmp_path / "o.vcf.gz")],
        stats=stats) == 0
    assert dc.DEVICE == CPU and dc.route_device(object()) is None
    assert stats["families_device"] == 0 and stats["regions"] >= 1
    assert _routes(stats) == {"host"}


@pytest.mark.parametrize("name", ["golden_small", "golden_iontorrent"])
def test_forced_route_keeps_the_goldens(inputs, monkeypatch, tmp_path, name):
    """The route on the CPU (its plain versions) in every region: the body
    byte-identical to the golden, every families span ``device``."""
    _, args = inputs
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path / "trace"))
    out = str(tmp_path / "o.vcf.gz")
    _, stats = capture(monkeypatch, args[name] + ["--device", "cpu", "-o",
                                                  out], route=True)
    assert stats["families_device"] == stats["regions"] >= 1
    assert _routes(stats) == {"device"}
    assert goldens.read_body(out) == goldens.golden(name)


@pytest.mark.parametrize("case", ["duplex", "consensus_fastq"])
def test_duplex_and_consensus_fastq_keep_the_host_route(inputs, monkeypatch,
                                                        tmp_path, case):
    _, args = inputs
    if case == "duplex":
        argv = args["golden_umi_duplex"]
    else:
        argv = args["golden_small"] + ["--fam-consensus-out-fastq",
                                       str(tmp_path / "cons")]
    got, stats = capture(monkeypatch, argv + [
        "--device", "cpu", "-o", str(tmp_path / "o.vcf.gz")], route=True)
    assert got == [] and stats["families_device"] == 0


def test_slots_and_params_follow_the_kernel_source():
    with open(os.path.join(REPO, "uvc_tpu_torch", "kernels", "csrc",
                           "family_chain.cu")) as fh:
        src = fh.read()

    def enum(name, prefix):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return [t.strip()[len(prefix):].lower() for t in body.split(",")
                if t.strip().startswith(prefix) and "N_" not in t]

    assert enum("Slot", "S_") == [nm for nm, _, _ in dc.SLOTS]
    assert enum("Param", "P_") == [p.lower() for p in dc.PARAMS]


def _body(fn):
    """fn's top-level statements (docstring out), as ast nodes."""
    src = textwrap.dedent(inspect.getsource(fn))
    body = ast.parse(src).body[0].body
    if isinstance(body[0], ast.Expr) and isinstance(body[0].value,
                                                    ast.Constant):
        body = body[1:]
    return body


def _dump(node):
    """The statement's structure, ``with ... as name`` read as ``with
    ...`` (the port keeps its families spans to set their route)."""
    node = ast.parse(ast.unparse(node))
    for w in ast.walk(node):
        if isinstance(w, ast.With):
            for item in w.items:
                item.optional_vars = None
    return ast.dump(node)


def _families_blocks(body):
    return [i for i, s in enumerate(body) if isinstance(s, ast.With)
            and "prepare.families" in ast.unparse(s.items[0].context_expr)]


def _pass_c(body, call):
    """(the index of the block holding the pass C statement, the index of
    the statement in it, the statement's call): the statement assigns the
    result of ``call``."""
    found = [(i, j, t.value) for i, s in enumerate(body)
             if isinstance(s, ast.With) for j, t in enumerate(s.body)
             if isinstance(t, ast.Assign) and isinstance(t.value, ast.Call)
             and ast.unparse(t.value.func) == call]
    assert len(found) == 1
    return found[0]


def _without(block, j):
    """A with block's items and its body but statement ``j``."""
    return ([_dump(ast.Expr(it.context_expr)) for it in block.items]
            + [_dump(t) for k, t in enumerate(block.body) if k != j])


@pytest.mark.parametrize("part", ["call_region", "host_chain",
                                  "fq_result"])
def test_host_steps_follow_their_copies(part):
    """The port's region and family steps around the route equal the ones
    tests/test_torch_host.py holds to the JAX package, statement for
    statement: call_region but for its routed pass C statement (the same
    arguments, to device_pass_c.route, and its planes taken by
    device_pass_c.result in the routed block), its second families block
    (the routed one) and its result; _host_chain as that block, the BQ
    result of the device branch as that block's; fq_result's tail as
    _run_fq_statics'."""
    if part == "fq_result":
        def tail(fn):
            body = _body(fn)
            i = next(k for k, s in enumerate(body)
                     if ast.unparse(s).startswith("c2info = "))
            return [_dump(s) for s in body[i:]]
        assert tail(dc.fq_result) == tail(engine_fq._run_fq_statics)
        return
    want, got = _body(region.call_region), _body(region_device.call_region)
    routed_w, routed_g = _families_blocks(want)[1], _families_blocks(got)[1]
    block = want[routed_w].body
    if part == "call_region":
        assert routed_w == routed_g and len(want) == len(got)
        assert isinstance(want[-1], ast.Return)
        i, j, c_w = _pass_c(want, "engine_bq.pass_c_scatter")
        assert (i, j) == _pass_c(got, "device_pass_c.route")[:2]
        c_g = _pass_c(got, "device_pass_c.route")[2]
        assert i < routed_w and [ast.dump(a) for a in c_w.args] == [
            ast.dump(a) for a in c_g.args] \
            and not c_w.keywords and not c_g.keywords
        assert [_dump(s) for k, s in enumerate(want[:routed_w]) if k != i] \
            == [_dump(s) for k, s in enumerate(got[:routed_g]) if k != i]
        assert _without(want[i], j) == _without(got[i], j)
        routed = {_dump(s) for s in ast.walk(got[routed_g])
                  if isinstance(s, ast.stmt)}
        took = ast.parse("info, bg, a1, a2 = device_pass_c.result(pc)").body
        assert _dump(took[0]) in routed
        assert ast.unparse(want[i].body[j].targets[0]) == "(info, bg, a1, a2)"
        bq = [s for s in block if isinstance(s, ast.Assign)
              and {n.id for t in s.targets for n in ast.walk(t)
                   if isinstance(n, ast.Name)} & {"bq_res", "bIAQ"}]
        assert len(bq) == 2 and all(_dump(s) in routed for s in bq)
        return
    host = _body(region_device._host_chain)
    assert isinstance(host[-1], ast.Return)
    assert [_dump(s) for s in host[:-1]] == [_dump(s) for s in block]


# ---- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _col(t, nc, n, m):
    return [t[c * n:c * n + m].cpu().to(torch.int64) for c in range(nc)]


def _same_cols(want, got):
    return len(want) == len(got) and all(
        torch.equal(a, b.cpu().to(torch.int64)) for a, b in zip(want, got))


@pytest.fixture(scope="module")
def card_regions(cuda, tmp_path_factory):
    """The ChainInputs of the bench job's regions and of golden_small's
    (uvc1 on the CPU, the host route kept)."""
    d = str(tmp_path_factory.mktemp("family_chain_card"))
    fa, bam = goldens.build_bench_input(d)
    args = goldens.build_inputs(d)
    mp = pytest.MonkeyPatch()
    try:
        bench, stats = capture(mp, ["-f", fa, "-t", "4", bam, "--device",
                                    "cpu", "-o", os.path.join(d, "o.vcf.gz")])
        small, _ = capture(mp, args["golden_small"] + [
            "--device", "cpu", "-o", os.path.join(d, "s.vcf.gz")])
    finally:
        mp.undo()
    assert len(bench) == stats["regions"] == 4
    return {"bench": bench, "golden_small": small}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("bench",) + dc.UMI_VARIANTS)
def test_kernels_match_their_plain_versions_on_the_card(cuda, card_regions,
                                                        case):
    """Each kernel's outputs on the card (the consensus rows, their mut
    flags and pass D's planes and rows; the s2 and good rows, fbeg/fend
    and the sweep-1 counters; sweep 2's planes, hist and m2 rows) against
    its plain version, the stream synchronised after each launch; then the
    route's arrays against the plain route's and the native chain's.  The
    bench job's regions (one fragment a family) and golden_small's region
    grouped into UMI families of 1-8 fragments (the k-way merge)."""
    if case == "bench":
        cis = card_regions["bench"]
    else:
        cis = [dc.umi_variant(card_regions["golden_small"][0], case)]
        assert np.bincount(cis[0].fam_of_frag).max() > 1
    for ci in cis:
        sizes, staged = dc.stage(ci)
        prm = dict(ci.prm)
        err, fr = dc.frag_merge_plain(staged, sizes, prm)
        assert err == 0
        cons, rowmut, pd_planes, mut, win = fr
        err, fm = dc.fam_merge_plain(cons, staged, sizes, prm)
        assert err == 0
        il, fbeg, fend, s2, g1 = fm
        err, sw = dc.sweep2_plain(il, s2, staged, sizes, prm)
        assert err == 0
        m2 = sw[2]
        run_ = dc.launch(ci, cuda, sync_each=True)
        run_["stream"].synchronize()
        n = sizes["n"]
        counts = dc.slot(run_, "counts").cpu()
        assert int(counts[dc.C_ERR]) == 0
        m = int(counts[dc.C_OUT])
        assert m == len(cons[0])
        for a, b in zip(cons, _col(dc.slot(run_, "cons"), 6, n, m)):
            assert torch.equal(a, b)
        assert torch.equal(rowmut, dc.slot(run_, "rowmut")[:m].cpu().bool())
        for nm, want in zip(("bdp", "bta", "btb", "hist_d", "vq_bmq"),
                            pd_planes):
            assert torch.equal(want.reshape(-1), dc.slot(run_, nm).cpu()), nm
        n_s2 = int(counts[dc.C_S2])
        assert n_s2 == len(s2[0])
        assert _same_cols(s2, _col(dc.slot(run_, "s2"), 7, n, n_s2))
        rows, _ = dc.row_tables(dc.slot(run_, "rows"), counts)
        for nm, want in (("mut", mut), ("win", win), ("g1", g1),
                         ("m2", m2)):
            assert _same_cols(want, rows[nm]), nm
        assert torch.equal(fbeg, dc.slot(run_, "fbeg").cpu())
        assert torch.equal(fend, dc.slot(run_, "fend").cpu())
        il_k = dc.slot(run_, "il").cpu().reshape(-1, 7).to(torch.int64)
        assert torch.equal(dc._wrap32(il[:, :6]).to(torch.int64), il_k[:, :6])
        got = dc.readback(run_)
        assert_same(dc._run_plain(ci, sizes, staged), got)
        assert_same(dc.native_chain(ci), got)
