"""The f32-parity workload (tests/test_f32_parity.py's and
tools/tpu_record_diff.py's: 12 kbp at depth 120, SNVs down to AF 0.06)
through the port and the JAX package, on the CPU, and the port's record
diff (``uvc_tpu_torch.utils.record_diff``) with its bar
(``goldens.record_diff``).

One module fixture runs, side by side: ``record_diff.run("cpu", ...)``
(the port's uvc1 --device cpu in f64 and in f32) and the JAX package's
uvc1 on the same workload in f64 and with ``UVC_TPU_MODEL_F32=1``
(``JAX_PLATFORMS=cpu``).  Bars: the port's f64 body byte-identical to the
JAX package's; the port's f32 body within the f32 contract of the JAX
package's f32 body and of the port's f64 body.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from uvc_tpu_torch import goldens
from uvc_tpu_torch.utils import record_diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_body(d, tag, env):
    bam, fa = goldens.build_f32_parity_input(d)
    out = os.path.join(d, f"{tag}.vcf.gz")
    r = subprocess.run(
        [sys.executable, "-m", "uvc_tpu.cli.uvc1", "-f", fa, "-o", out, "-t",
         "1", bam], env=dict(os.environ, JAX_PLATFORMS="cpu",
                             PYTHONPATH=REPO, **env),
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return goldens.read_body(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's record_diff result on the CPU, {regime: the JAX
    package's body})."""
    dirs = [str(tmp_path_factory.mktemp(n)) for n in ("port", "jax64",
                                                      "jax32")]
    with ThreadPoolExecutor(3) as pool:
        port = pool.submit(record_diff.run, "cpu", dirs[0])
        j64 = pool.submit(_jax_body, dirs[1], "f64", {})
        j32 = pool.submit(_jax_body, dirs[2], "f32",
                          {"UVC_TPU_MODEL_F32": "1"})
        return port.result(), {"f64": j64.result(), "f32": j32.result()}


def test_port_f64_is_jax_f64(runs):
    port, jax = runs
    same, errs = goldens.compare(port["bodies"]["golden"], jax["f64"], "f64")
    assert same and not errs, "\n".join(errs[:30])
    assert port["records"] == 17


def test_port_f32_holds_jax_f32(runs):
    port, jax = runs
    same, errs = goldens.compare(port["bodies"]["device"], jax["f32"], "f32")
    print(f"the port's cpu f32 body byte-identical to the JAX package's: "
          f"{same}")
    assert not errs, "\n".join(errs[:30])


def test_record_diff_cpu(runs):
    """The port's tests/test_f32_parity.py: the cpu f32 leg within the
    contract of the cpu f64 leg, the 0.06-AF SNV at 8001 among the
    records; no leg failed, and no card leg ran."""
    port, _ = runs
    assert not port["failed"] and not port["divergences"], \
        "\n".join(port["failed"] + port["divergences"][:30])
    assert port["records"] >= 4
    assert set(port["bodies"]) == {"golden", "device"}
    assert port["devices"] == {"golden": "cpu", "device": "cpu"}
    assert any(l.split("\t")[1] == "8001" and l.split("\t")[4] != "<NON_REF>"
               for l in port["bodies"]["golden"] if not l.startswith("#"))


def _edit(body, how):
    """A copy of ``body`` with its first PASS record edited ``how``."""
    out = list(body)
    i = next(i for i, l in enumerate(out) if "\tPASS\t" in l)
    c = out[i].split("\t")
    keys, vals = c[8].split(":"), c[9].split(":")

    def fmt(tag, f):
        k = keys.index(tag)
        vals[k] = f(vals[k])
        c[9] = ":".join(vals)

    def int_plus(n):
        return lambda v: ",".join([str(int(v.split(",")[0]) + n)]
                                  + v.split(",")[1:])
    if how == "qual+0.5":
        c[5] = f"{float(c[5]) + 0.5:f}"
    elif how == "qual+0.6":
        c[5] = f"{float(c[5]) + 0.6:f}"
    elif how == "format+1":
        fmt("AD", int_plus(1))
    elif how == "format+2":
        fmt("AD", int_plus(2))
    elif how == "filter":
        c[6] = "Q60"
    elif how == "string":
        fmt("VTD", lambda v: v[:-1] + ("C" if v[-1] != "C" else "T"))
    elif how == "dropped":
        del out[i]
        return out
    elif how == "added":
        c[1] = str(int(c[1]) + 1)
        out.insert(i + 1, "\t".join(c))
        return out
    out[i] = "\t".join(c)
    return out


@pytest.mark.parametrize("how,flagged", [
    ("qual+0.5", False), ("format+1", False), ("qual+0.6", True),
    ("format+2", True), ("filter", True), ("dropped", True), ("added", True),
    ("string", True), ("three_records", True)])
def test_record_diff_flags(runs, how, flagged):
    """goldens.record_diff on edited copies of the port's f64 body: QUAL
    within 0.51 and FORMAT within 1 pass; the rest is a divergence, a
    body of 3 records too (the workload too small to tell)."""
    want = runs[0]["bodies"]["golden"]
    if how == "three_records":
        recs = [l for l in want if not l.startswith("#")]
        want = [want[0]] + recs[:3]
        got = want
    else:
        got = _edit(want, how)
        assert got != want
    errs = goldens.record_diff(got, want)
    assert bool(errs) == flagged, errs


@pytest.mark.parametrize("keep_going", [False, True])
def test_record_diff_needs_a_card(tmp_path, keep_going):
    """Without a card, --device cuda fails with the CLI's error (exit 2)
    and never runs a card leg on the CPU; with --keep-going the CPU f64
    leg still ends and is reported, and the two card legs are counted as
    failed."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this is the no-card check")
    r = subprocess.run(
        [sys.executable, "-m", "uvc_tpu_torch.utils.record_diff",
         "--device", "cuda"] + (["--keep-going"] if keep_going else []),
        env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path)),
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 2, (r.stdout, r.stderr[-3000:])
    assert "torch.cuda.is_available() is false" in r.stderr
    assert "RECORD-DIFF: OK" not in r.stdout
    if keep_going:
        assert "over 17 records, 2 failed legs" in r.stdout, r.stdout
