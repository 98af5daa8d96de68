"""The committed golden workloads, the bench workload, and the bars the
port is held to on them.

``build_inputs`` simulates the BAM/FASTA inputs of golden_small,
golden_umi_duplex and golden_iontorrent exactly as tests/test_golden.py
does, and returns each one's uvc1 arguments; ``build_tn_inputs`` those of
golden_tn (a tumor and a normal BAM) as uvctn arguments;
``build_bench_input`` those of bench.py's end-to-end workload, and
``build_tn_bench_inputs`` a tumor-normal pair at that scale, and
``build_f32_parity_input`` tools/tpu_record_diff.py's low-AF workload.
``compare`` holds a VCF body against a golden (or a reference run's
body):

- ``"f64"`` bar (the golden regime, tests/test_golden.py's
  ``body == expect``): the body byte-identical, ``#CHROM`` line
  included; each differing line is one divergence naming its first
  differing column (and FORMAT tag);
- ``"f32"`` bar (tests/test_f32_parity.py's contract for the accelerator
  regime): the same records (CHROM, POS, REF, ALT) and FILTERs, QUAL
  within 0.51, every numeric FORMAT value of every sample column within
  1, string fields equal.

Both also report whether the body is byte-identical.  ``record_diff`` is
the f32 bar as tools/tpu_record_diff.py applies it.
"""

import os

from .io import bgzf, simulate

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")
NAMES = ("golden_small", "golden_umi_duplex", "golden_iontorrent")


def build_inputs(d):
    """{golden name: uvc1 argv (without -o)} with inputs written to d."""
    out = {}
    ref = simulate.random_ref(6000, 42)
    variants = [
        simulate.Variant(1000, f"{ref[1000]}>"
                         + ("A" if ref[1000] != "A" else "G"), 0.3),
        simulate.Variant(2500, "+CT", 0.3),
        simulate.Variant(4200, "-2", 0.3),
    ]
    simulate.build_bam(os.path.join(d, "g.bam"), ref, depth=100,
                       variants=variants, seed=1234)
    _fasta(os.path.join(d, "ref.fa"), ref)
    out["golden_small"] = ["-f", os.path.join(d, "ref.fa"), "-t", "1",
                           os.path.join(d, "g.bam")]

    ref = simulate.random_ref(4000, 91)
    variants = [simulate.Variant(1200, f"{ref[1200]}>"
                                 + ("A" if ref[1200] != "A" else "G"), 0.4),
                simulate.Variant(2800, "+TG", 0.4)]
    simulate.build_bam(os.path.join(d, "ud.bam"), ref, depth=160,
                       variants=variants, seed=77, umi=True, duplex=True,
                       n_umi_families=60)
    _fasta(os.path.join(d, "ud.fa"), ref)
    out["golden_umi_duplex"] = ["-f", os.path.join(d, "ud.fa"), "-t", "1",
                                os.path.join(d, "ud.bam")]

    ref = simulate.random_ref(4000, 92)
    variants = [simulate.Variant(1500, f"{ref[1500]}>"
                                 + ("C" if ref[1500] != "C" else "T"), 0.35),
                simulate.Variant(2600, "-2", 0.35)]
    simulate.build_bam(os.path.join(d, "it.bam"), ref, depth=120,
                       variants=variants, seed=78)
    _fasta(os.path.join(d, "it.fa"), ref)
    out["golden_iontorrent"] = ["-f", os.path.join(d, "it.fa"), "-t", "1",
                                os.path.join(d, "it.bam"),
                                "--sequencing-platform", "2"]
    return out


def build_tn_inputs(d):
    """uvctn argv (without options) of golden_tn, inputs written to d;
    the normal VCF is <d>/tn.normal.vcf.gz."""
    ref = simulate.random_ref(4000, 93)
    tvars = [simulate.Variant(1100, f"{ref[1100]}>"
                              + ("A" if ref[1100] != "A" else "C"), 0.3),
             simulate.Variant(2400, f"{ref[2400]}>"
                              + ("G" if ref[2400] != "G" else "T"), 0.5)]
    nvars = [tvars[1]]   # germline
    fa = os.path.join(d, "tn.fa")
    _fasta(fa, ref)
    simulate.build_bam(os.path.join(d, "t.bam"), ref, depth=140,
                       variants=tvars, seed=81)
    simulate.build_bam(os.path.join(d, "n.bam"), ref, depth=140,
                       variants=nvars, seed=82)
    return [fa, os.path.join(d, "t.bam"), os.path.join(d, "n.bam"),
            os.path.join(d, "tn"), "TS,NS"]


def build_tn_bench_inputs(d):
    """(fasta, tumor bam, normal bam) of a tumor-normal pair at bench
    scale, written to d: the tumor is bench.py's 45,000-read workload plus
    3 germline SNVs at AF 0.5; the normal is the same reference at depth
    150 with those germline SNVs, from another seed."""
    ref = simulate.random_ref(30000, 5)
    somatic = [simulate.Variant(p, f"{ref[p]}>"
                                + ("A" if ref[p] != "A" else "C"), 0.25)
               for p in range(2000, 28000, 2500)]
    germline = [simulate.Variant(p, f"{ref[p]}>"
                                 + ("G" if ref[p] != "G" else "T"), 0.5)
                for p in (5300, 15300, 25300)]
    tbam, nbam = os.path.join(d, "tn_t.bam"), os.path.join(d, "tn_n.bam")
    fa = os.path.join(d, "tn_bench.fa")
    simulate.build_bam(tbam, ref, depth=150, variants=somatic + germline,
                       seed=6)
    simulate.build_bam(nbam, ref, depth=150, variants=germline, seed=7)
    _fasta(fa, ref)
    return fa, tbam, nbam


def build_bench_input(d):
    """(fasta, bam) of bench.py's workload, written to d: 45,000 aligned
    reads over 30 kbp at depth 150 with 11 SNVs at AF 0.25."""
    ref = simulate.random_ref(30000, 5)
    variants = [simulate.Variant(p, f"{ref[p]}>"
                                 + ("A" if ref[p] != "A" else "C"), 0.25)
                for p in range(2000, 28000, 2500)]
    bam, fa = os.path.join(d, "bench.bam"), os.path.join(d, "bench.fa")
    simulate.build_bam(bam, ref, depth=150, variants=variants, seed=6)
    _fasta(fa, ref)
    return fa, bam


def build_f32_parity_input(d):
    """(bam, fasta) of the f32-parity workload (tests/test_f32_parity.py,
    tools/tpu_record_diff.py), written to d: 12 kbp at depth 120, a SNV
    at AF 0.35, +CT and -2 at 0.30, and SNVs at 0.12 and 0.06, the
    low-AF calls where f32 rounding would first cross the vqual gate."""
    ref = simulate.random_ref(12000, 99)
    variants = [
        simulate.Variant(1500, f"{ref[1500]}>"
                         + ("A" if ref[1500] != "A" else "G"), 0.35),
        simulate.Variant(3000, "+CT", 0.30),
        simulate.Variant(4500, "-2", 0.30),
        simulate.Variant(6000, f"{ref[6000]}>"
                         + ("C" if ref[6000] != "C" else "T"), 0.12),
        simulate.Variant(8000, f"{ref[8000]}>"
                         + ("T" if ref[8000] != "T" else "A"), 0.06),
    ]
    bam = os.path.join(d, "f32_parity.bam")
    fa = os.path.join(d, "f32_parity.fa")
    simulate.build_bam(bam, ref, depth=120, variants=variants, seed=77)
    _fasta(fa, ref)
    return bam, fa


def _fasta(path, ref):
    with open(path, "w") as fh:
        fh.write(">chr1\n" + ref + "\n")


def body(vcf_text):
    """The lines a golden pins: #CHROM and the records (## meta carries
    the date and command line)."""
    return [l for l in vcf_text.splitlines() if not l.startswith("##")]


def read_body(path):
    """body() of a bgzipped VCF file."""
    with open(path, "rb") as fh:
        return body(bgzf.decompress(fh.read()).decode())


def golden(name):
    with open(os.path.join(GOLDEN_DIR, name + ".vcf")) as fh:
        return fh.read().splitlines()


def _parse(lines):
    out = {}
    for l in lines:
        if l.startswith("#"):
            continue
        c = l.split("\t")
        keys = c[8].split(":")
        fmts = tuple(dict(zip(keys, col.split(":"))) for col in c[9:])
        out[(c[0], c[1], c[3], c[4])] = (c[5], c[6], fmts)
    return out


def _num_close(a, b, tol=1):
    try:
        va = [float(x) if x not in (".", "") else 0.0 for x in a.split(",")]
        vb = [float(x) if x not in (".", "") else 0.0 for x in b.split(",")]
    except ValueError:
        return None
    return len(va) == len(vb) and all(abs(x - y) <= tol
                                      for x, y in zip(va, vb))


_COLUMNS = ("CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
            "FORMAT")


def _line_diff(lg, lw):
    """Where line ``lg`` first differs from ``lw``: its column, and for a
    sample column the first differing FORMAT tag."""
    cg, cw = lg.split("\t"), lw.split("\t")
    for c, (a, b) in enumerate(zip(cg, cw)):
        if a == b:
            continue
        if c < len(_COLUMNS):
            return f"column {c + 1} ({_COLUMNS[c]}) {a!r} != {b!r}"
        keys = cw[8].split(":") if len(cw) > 8 else []
        for k, (x, y) in enumerate(zip(a.split(":"), b.split(":"))):
            if x != y:
                tag = keys[k] if k < len(keys) else f"#{k}"
                return f"column {c + 1} (sample {c - 9} {tag}) {x!r} != {y!r}"
        return f"column {c + 1} (sample {c - 9}) {a!r} != {b!r}"
    return f"{len(cg)} columns, golden {len(cw)}"


def _byte_divergences(got, want):
    errs = [f"line {i + 1} {lg.split(chr(9))[:2]}: {_line_diff(lg, lw)}"
            for i, (lg, lw) in enumerate(zip(got, want)) if lg != lw]
    if len(got) != len(want):
        errs.append(f"{len(got)} body lines, golden {len(want)}")
    return errs


def compare(got, want, bar):
    """(byte_identical, [divergences]) of body ``got`` against golden
    body ``want`` under ``bar`` ("f64" or "f32")."""
    if bar == "f64":
        errs = _byte_divergences(got, want)
        return not errs, errs
    pg, pw = _parse(got), _parse(want)
    errs = []
    if set(pg) != set(pw):
        errs.append(f"record sets differ: only-got {sorted(set(pg) - set(pw))}"
                    f" only-golden {sorted(set(pw) - set(pg))}")
    for key in sorted(set(pg) & set(pw)):
        qg, fg, mg = pg[key]
        qw, fw, mw = pw[key]
        if fg != fw:
            errs.append(f"{key} FILTER {fg} != {fw}")
        if "." in (qg, qw):
            if qg != qw:
                errs.append(f"{key} QUAL {qg} != {qw}")
        elif abs(float(qg) - float(qw)) > 0.51:
            errs.append(f"{key} QUAL {qg} vs {qw}")
        if len(mg) != len(mw):
            errs.append(f"{key} {len(mg)} sample columns, golden "
                        f"{len(mw)}")
            continue
        for col, (sg, sw) in enumerate(zip(mg, mw)):
            if set(sg) != set(sw):
                errs.append(f"{key} sample {col} FORMAT keys differ")
                continue
            for tag, vw in sw.items():
                vg = sg[tag]
                if vg == vw:
                    continue
                ok = _num_close(vg, vw)
                if ok is None:
                    errs.append(f"{key} sample {col} {tag} string {vg!r} "
                                f"!= {vw!r}")
                elif not ok:
                    errs.append(f"{key} sample {col} {tag} {vg} vs {vw}")
    return got == want, errs


def record_diff(got, want):
    """tools/tpu_record_diff.py's divergences of body ``got`` against the
    reference body ``want``: the f32 bar, and a reference of fewer than 4
    records is itself one (the workload is too small to tell)."""
    errs = compare(got, want, "f32")[1]
    n = len(_parse(want))
    if n < 4:
        errs.append(f"workload too small: {n} records")
    return errs
