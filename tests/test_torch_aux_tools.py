"""The port's host CLIs uvcnorm, active_region and surrogate_align (copies
of the JAX package's), the ports of tests/test_aux_tools.py's debarcode,
uvcnorm and active_region tests and of tests/test_surrogate.py; the
realign test's re-call runs the port's uvc1 --device cpu.  The debarcode
tests build bin/debarcode first, as the port's native libraries are built
(``make -C native`` at first use), so they run on a fresh checkout."""

import contextlib
import fcntl
import gzip
import io
import os
import random
import subprocess

import pytest

from uvc_tpu_torch.cli import active_region, surrogate_align, uvcnorm
from uvc_tpu_torch.io import bam as bam_mod
from uvc_tpu_torch.io import bgzf, simulate
from uvc_tpu_torch.utils import nativebuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBARCODE = os.path.join(REPO, "bin", "debarcode")


@pytest.fixture(scope="module")
def debarcode():
    """bin/debarcode: ``nativebuild.ensure_built()`` runs ``make -C
    native`` on a checkout without bin/; where the libraries were built
    before, the binary alone is made, under the same build lock."""
    nativebuild.ensure_built()
    if not os.path.exists(DEBARCODE):
        lock = os.open(os.path.join(REPO, "native", ".build.lock"),
                       os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                            "../bin/debarcode"], capture_output=True,
                           timeout=600, check=True)
        finally:
            os.close(lock)
    assert os.path.exists(DEBARCODE)
    return DEBARCODE


def test_debarcode_moves_umi_to_name(tmp_path, debarcode):
    r1 = str(tmp_path / "r1.fq.gz")
    with gzip.open(r1, "wt") as fh:
        fh.write("@read1\nACGTACGTTTTTGGGG\n+\nIIIIIIIIIIIIIIII\n")
        fh.write("@read2\nTTTTAAAACCCCGGGG\n+\nIIIIIIIIIIIIIIII\n")
    out1 = str(tmp_path / "o1.fq.gz")
    rc = subprocess.run([debarcode, "-i", r1, "-o", out1, "-b", "0", "-e",
                         "4"], capture_output=True)
    assert rc.returncode == 0, rc.stderr
    with gzip.open(out1, "rt") as fh:
        lines = fh.read().splitlines()
    assert lines[0].startswith("@read1#ACGT")
    # the reference debarcode leaves the sequence intact
    # (debarcode_main.c:128 writes seq.s/seq.l unmodified)
    assert lines[1] == "ACGTACGTTTTTGGGG"
    assert lines[4].startswith("@read2#TTTT")


def test_debarcode_duplex(tmp_path, debarcode):
    r1 = str(tmp_path / "r1.fq.gz")
    r2 = str(tmp_path / "r2.fq.gz")
    with gzip.open(r1, "wt") as fh:
        fh.write("@m\nAGTACCCC\n+\nIIIIIIII\n")
    with gzip.open(r2, "wt") as fh:
        fh.write("@m\nTGGTAAAA\n+\nIIIIIIII\n")
    o1 = str(tmp_path / "o1.fq.gz")
    o2 = str(tmp_path / "o2.fq.gz")
    rc = subprocess.run([debarcode, "-i", r1, "-o", o1, "-b", "0", "-e", "4",
                         "-j", r2, "-p", o2, "-c", "0", "-f", "4", "-D"],
                        capture_output=True)
    assert rc.returncode == 0, rc.stderr
    with gzip.open(o1, "rt") as fh:
        name = fh.readline().strip()
    assert "#AGTA+TGGT" in name


def test_uvcnorm_filters_by_qual(tmp_path):
    header = ("##fileformat=VCFv4.2\n"
              "##contig=<ID=chr1,length=1000>\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    fmtk = "GT:cVQ1M:cVQ2M:cVQ1:cVQ2"
    recs = (f"chr1\t100\t.\tA\tC\t80\tPASS\tSOMATIC\t{fmtk}\t./1:80:0:80:0\n"
            # drops: q=20 < 58.5 and the consensus-allele rescue fails
            # (another allele holds the max cVQ1M)
            f"chr1\t200\t.\tA\tG\t20\tQ20\tSOMATIC\t{fmtk}\t./1:50:0:20:0\n"
            f"chr1\t300\t.\tAT\tA\t60\tPASS\tSOMATIC\t{fmtk}\t./1:60:0:60:0\n")
    inp = str(tmp_path / "in.vcf.gz")
    with open(inp, "wb") as fh:
        fh.write(bgzf.compress((header + recs).encode()) + bgzf.BGZF_EOF)
    outp = str(tmp_path / "out.vcf.gz")
    rc = uvcnorm.run([inp, outp])
    assert rc == 0 or rc is None
    body = [l for l in bgzf.read_file(outp).decode().splitlines()
            if not l.startswith("#")]
    assert {int(l.split("\t")[1]) for l in body} == {100, 300}


def test_active_region_bed(tmp_path):
    d = str(tmp_path)
    ref = simulate.random_ref(4000, 33)
    variants = [simulate.Variant(2000, f"{ref[2000]}>"
                                 + ("A" if ref[2000] != "A" else "C"), 0.5)]
    path = d + "/a.bam"
    simulate.build_bam(path, ref, depth=50, variants=variants, seed=2)
    with open(d + "/ref.fa", "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = active_region.run([path, "-f", d + "/ref.fa"])
    assert rc == 0 or rc is None
    lines = [l.split("\t") for l in buf.getvalue().splitlines() if l]
    assert any(int(l[1]) <= 2000 < int(l[2]) for l in lines), lines


def test_surrogate_extract_and_merge(tmp_path):
    ref = simulate.random_ref(3000, 3)
    bam_path = str(tmp_path / "t.bam")
    simulate.build_bam(bam_path, ref, depth=30, seed=4)
    invcf = str(tmp_path / "in.vcf")
    with open(invcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("chr1\t1500\t.\tA\t<ADDITIONAL_INDEL_CANDIDATE>\t.\t.\t.\n")
        fh.write("chr1\t1550\t.\tC\t<ADDITIONAL_INDEL_CANDIDATE>\t.\t.\t.\n")
        fh.write("chr1\t900\t.\tG\tA\t50\tPASS\tANY_VAR\n")
    outdir = str(tmp_path / "surr")
    surrogate_align.run(["extract", invcf, bam_path, "-o", outdir])
    with open(outdir + "/superactive.bed") as fh:
        bed = fh.read().splitlines()
    assert len(bed) == 2  # track line + one merged interval (pads overlap)
    chrom, beg, end = bed[1].split("\t")
    assert int(beg) <= 1379 and int(end) >= 1670
    with gzip.open(outdir + "/surrogate.R1.fastq.gz", "rt") as fh:
        assert fh.read().count("@") >= 10  # reads overlapping the region

    # merge: a surrogate long-indel germline call is grafted over the
    # original
    surr = str(tmp_path / "surrogate.vcf")
    with open(surr, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        fh.write("chr1\t1500\t.\tA" + "T" * 20 + "\tA\t60\tPASS\tGERMLINE\n")
        fh.write("chr1\t1600\t.\tG\tC\t60\tPASS\tGERMLINE\n")  # short: dropped
    outvcf = str(tmp_path / "merged.vcf")
    surrogate_align.run(["merge", outvcf, invcf, surr])
    with open(outvcf) as fh:
        body = [l for l in fh.read().splitlines() if not l.startswith("#")]
    assert any("T" * 20 in l for l in body)       # long indel merged in
    assert not any("\t1600\t" in l for l in body)  # short surrogate dropped
    assert any("\t900\t" in l for l in body)       # original kept


def test_realign_recovers_long_deletion(tmp_path):
    """``realign`` (native/swalign.cpp): reads carrying a 20 bp deletion
    are re-aligned with the deletion at the right coordinates, and the
    port's uvc1 --device cpu over the surrogate BAM emits the deletion
    record."""
    from uvc_tpu_torch.cli import uvc1
    random.seed(11)
    ref = simulate.random_ref(2400, 11)
    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")
    outdir = str(tmp_path / "surr")
    os.makedirs(outdir)
    with open(outdir + "/superactive.bed", "w") as fh:
        fh.write("track name=superactive\n")
        fh.write("chr1\t1000\t1400\n")
    # reads: 60% span the 20 bp deletion at 1200..1220, 40% are clean
    del_hap = ref[:1200] + ref[1220:]
    r1s = []
    for i in range(60):
        src = del_hap if i % 5 < 3 else ref
        start = random.randint(1000, 1120)
        r1s.append(f"@sd{i:03d}\n{src[start:start + 150]}\n+\n"
                   + "I" * 150 + "\n")
    with gzip.open(outdir + "/surrogate.SE.fastq.gz", "wt") as fh:
        fh.write("".join(r1s))
    for suffix in ("R1", "R2"):
        with gzip.open(outdir + f"/surrogate.{suffix}.fastq.gz", "wt"):
            pass
    obam = str(tmp_path / "surrogate.bam")
    surrogate_align.run(["realign", outdir, fa, "-o", obam])
    _, batch = bam_mod.read_bam(obam)
    assert batch.n >= 55, batch.n
    n_del = 0
    for i in range(batch.n):
        p = int(batch.pos[i])
        for k in range(batch.cigar_off[i], batch.cigar_off[i + 1]):
            op, ln = int(batch.cigar_op[k]), int(batch.cigar_len[k])
            if op == 2 and ln == 20:
                n_del += 1
                assert p <= 1200
        assert 950 <= p <= 1260, p
    assert n_del >= 15, n_del
    out = str(tmp_path / "surr.vcf.gz")
    assert uvc1.run(["-f", fa, "-o", out, "-t", "1", "--device", "cpu",
                     "--outvar-flag", "15", obam]) == 0
    body = bgzf.read_file(out).decode()
    want_ref = ref[1199:1220]
    hits = [l for l in body.splitlines() if not l.startswith("#")
            and l.split("\t")[1] == "1200" and l.split("\t")[3] == want_ref]
    assert hits, [l.split("\t")[:5] for l in body.splitlines()
                  if not l.startswith("#")][:8]
