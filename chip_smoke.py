#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uvc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, each of which raises on failure:

1. print the card (nvidia-smi name and power limit); no CUDA -> exit 1;
2. build the kernels (kernels/csrc/*.cu), print the time and each
   kernel's registers, stack and spills from ptxas;
3. on a 65,536-row packed model request of real example planes (a
   4,096-row payload tiled 16 times), and on its first 128 rows (the
   request the main path sends), hold each kernel against its plain
   PyTorch version on the card, from the same inputs, in both regimes,
   and time both with CUDA events beside the kernel's bound
   (kernels/bounds.py), and at 128 rows, where the host's launch rate
   bounds the event mean, also by torch.profiler's trace of the card
   (``device_ms``).  Bars: K1 (integer sums and float32 square
   roots, no transcendental) 0 differing entries; K2/K3 f64 ints equal
   but for at most 0.01% of a leaf's entries, each within 1 (the card's
   exp/log and torch's can differ in the last ulp), floats within rtol
   1e-12; f32 ints within 1, floats within rtol 1e-5;
4. run uvc1 --device cuda on the three committed golden workloads: f64
   byte-identical to the golden, f32 against the accelerator contract
   (same records and FILTERs, QUAL within 0.51, FORMAT within 1);
5. the main path: uvc1 --device cuda --model-regime f32 on the 45,000-read
   bench workload (30 kbp, depth 150) at -t = cores, with the kernels'
   launch counters set to 0 just before its three timed runs and read
   just after; every model request (128 rows each) must have gone
   through K1-K3.  Its VCF is held to the f32 contract against a
   --device cpu --model-regime f64 run of the same input;
6. K1-K3 on the normal run's requests in its two modes, rescued (a
   seeded quarter of the entries carry tumor allele fractions) and
   normal (none), against their plain versions at 65,536 and 128 rows in
   both regimes, under phase 3's bars, timed as in phase 3;
7. uvctn --device cuda on golden_tn: f64 byte-identical to the golden,
   f32 against the contract, both sample columns;
8. the tumor-normal main path: uvctn --device cuda --model-regime f32 at
   -t = cores on a tumor BAM (the bench workload plus 3 germline SNVs)
   and a normal BAM (depth 150, the germline SNVs), one warm-up and three
   timed runs with the launch counters set to 0 just before them and read
   just after: every request through K1-K3 and every rescued request
   through the rescued K2/K3 launches.  The normal VCF is held to the f32
   contract against a --device cpu --model-regime f64 pair;
9. B1, the fragment consensus: dc_sort and dc_segments against their
   plain versions on random tables at N = 2^20 (mode max/sum x
   link_m_overridden), on a wide-key table at N = 2^20 (full-range int32
   group and pos, negative values: its sort plans take two 64-bit
   words) and on the largest real fragment stream of the bench workload,
   0 differing entries, both timed, each radix sort's plan printed;
   dc_segments also by its device time (torch.profiler: the summed
   durations of a call's kernels and memset, ``SEG_FAMILY``, each name
   required in nine tenths of its records), beside its bound (the bytes
   of the columns each stage must read and write, the columns of rows
   that are not ok excepted, ``b1_bounds``) and the share of it reached,
   and run 20 more times on the real stream and on the random
   max/link_m_overridden table, stage 2 on stage 1's scratch, every
   entry held to the plain version's and to the first run's each time;
   then the bench workload through uvc1 --device cuda with
   UVC_TPU_DEVICE_PREPARE=1, counters set to 0 just before and read just
   after: each consensus call launches dc_sort and dc_segments twice,
   and the VCF body is byte-identical to phase 5's gate-off body; the
   real stream is saved for phase 10;
10. with --parent DIR (another checkout, e.g. the parent commit unpacked
   with ``git archive``), run last: kernel_times.py times K1-K3 and
   (``--b1``) dc_segments of DIR and of this tree in turns, parent,
   change, change, parent, one process each, dc_segments on phase 9's
   random 2^20 table and real stream, sorted by the plain versions; the
   parent's K1 times go into K1's row as "was", its dc_segments times
   (events and device, the mean of its two turns) into dc_segments' row;
11. B2 (utils/device_bench.py): 10 chained evaluations of the model on a
   65,536-row f32 request kept on the card, best of 3 loops, with the
   launch counters read around it; rows/s and ms per evaluation with and
   without the perturbing add, beside the bound (K1+K2+K3 from
   kernels/bounds.py plus the add's read and write of the wire at
   3.35 TB/s).  The int32 accumulator must equal the same loop's over
   the kernels' plain versions on the card; a second run with
   UVC_TPU_TORCH_TRACE_DIR set must write a trace;
12. C (parallel/dryrun.py): entry("cuda") against the same step on the
   plain versions under phase 3's f32 bars, then dryrun_multidevice at
   full scale over 4 slots of card 0 (and over every card, where there is
   more than one), with every assertion of the JAX dry run;
13. the card's idle share on the main path: phase 5's command once more
   under utils/profiling.maybe_trace; the union of the CUDA kernels'
   intervals in the exported trace against the traced wall, or "not
   measured" where the trace kept fewer kernel records than the
   counters counted;
14. two processes: phase 5's command as two ``python -m
   uvc_tpu_torch.cli.uvc1`` processes under UVC_TPU_COORDINATOR (gloo,
   a local port), each at -t = half the cores, started before phase 12
   and run beside its host-bound dry run; the merged body must be
   byte-identical to phase 5's, and each process must have launched K1
   once for each of its requests;
15. the f32-parity workload (tools/tpu_record_diff.py's: 12 kbp at depth
   120, SNVs down to AF 0.06) through utils/record_diff.py: three uvc1
   processes at -t 1 side by side, cpu f64, cuda f32 and cuda f64,
   started with phase 14's and run beside phase 12's dry run; the
   cuda f32 body within the f32 contract of the cpu f64 body (at least 4
   records), the cuda f64 body byte-identical to it, and each card leg,
   a fresh process whose launch counters start at 0, must have launched
   K1-K3 once for each of its model requests (its summary line).
16. the family chain on the card (family/device_chain.py), run after
   phase 5 on its bench job: each region's arrays from the card held to
   the plain versions' and to the host route's (native) array for array,
   and per region the route's host wall, each kernel's device time
   (torch.profiler) beside its bound in bytes (``chain_bounds``), the
   plain versions' and the host route's wall, and the copies' device
   time.  Phases 4 and 5 also print in which regions the chain took the
   device route: every region of each golden but golden_umi_duplex
   (duplex-flagged: the host route), every region of the main path.
   Phase 16 then runs golden_small's region grouped into single-strand
   UMI families of 1-8 fragments (device_chain.umi_variant: plain,
   rescue_add 4, fam_flag 0x2) on the card, held array for array to the
   plain and native chains: the family merge's k-way path.
17. pass C on the card (pileup/device_pass_c.py), run after phase 16 on
   the bench job: one uvc1 run recording each region's pass C arguments
   and the family chain the card ran on pass C's columns; per region the
   kernel's planes and aDP4 held entry for entry to the plain version's,
   the route's result to the native pass's, and the chain's arrays to the
   chain run on the native pass's bg and aDP4 (0 differing entries each);
   the route's host wall (staging, upload, launches, readback; median of
   5), the kernels' device time (torch.profiler), their bound in bytes
   (``pass_c_bounds``) and the share reached, the plain version's and
   the native pass's wall.  Phases 4 and 5 also require pass C on the
   card in every region (golden_umi_duplex too), and phases 5 and 15 its
   two launches a region.

Phase 9 also times the two sorts' library route (``library_sort``: a
stable torch.sort of each packed 64-bit key word, then one gather), held
to dc_sort_plain on the same tables, as dc_sort's ``library_ms``.

The line before the last is a JSON object of per-kernel results (each
model kernel's first numbers at the main path's shape, f32 and 128 rows)
and of phases 11-15; the last is {"ok": true, "device": {...}}.  Nothing of JAX or of the JAX
package uvc_tpu is imported: the script blocks both.
"""

from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 65536
MAIN_ROWS = 128     # the request the main path sends (calling._bucket)
TILE = 4096


# the port imports nothing of JAX and nothing of the JAX package
BLOCKED = ("jax", "jaxlib", "uvc_tpu")


class _BlockReference:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name}: the port must not import JAX or "
                              "the JAX package")
        return None


def ptxas_table(log):
    """[{name, registers, stack, spill_stores, spill_loads}] of every
    kernel in nvcc's -Xptxas -v log, names demangled by c++filt where it
    is found."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"name": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    try:
        dem = subprocess.run(["c++filt"], input="\n".join(
            e["name"] for e in out), capture_output=True, text=True,
            check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        dem = [e["name"] for e in out]
    for e, d in zip(out, dem):
        d = d.replace("(anonymous namespace)::", "")
        m = re.search(r"(\w+<[^()]*>)\(", d)
        e["name"] = m.group(1) if m else d.split("(")[0].split("::")[-1]
    return out


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls, after
    one warm-up call, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, kernels, tries=3):
    """Mean device milliseconds of one call of ``fn`` over ``reps`` calls,
    from torch.profiler's trace of the card.  ``kernels`` maps each record
    name a call must leave (a kernel's name, or each of a family's when a
    call launches several; a trace's key holds it) to its records a call;
    a call's time is the sum, over the names, of the mean duration of the
    name's records times its records a call.  The trace runs under a
    schedule whose warm-up step holds one more call, so that the card's
    tracing starts before the recorded window.  A window in which any name
    kept fewer than nine tenths of the records it should is run again,
    and after ``tries`` such windows the time is not measured (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    first = next(iter(kernels))
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        evs = list(prof.key_averages())
        kept = {}   # name: (records, device us)
        for name in kernels:
            mine = [e for e in evs if name in e.key]
            kept[name] = (sum(e.count for e in mine),
                          sum(e.device_time_total for e in mine))
        if len(kernels) > 1:
            print("  device time records: " + ", ".join(
                f"{name} x{n} " + (f"{us / n / 1e3:.5f} ms" if n else "-")
                for name, (n, us) in kept.items()))
        short = {name: n for name, (n, _) in kept.items()
                 if n < reps * kernels[name]}
        if short:
            print(f"  device time of {first}: a trace window kept "
                  + ", ".join(f"{n} of {reps * kernels[name]} {name}"
                              for name, n in short.items()))
        if all(n >= 0.9 * reps * kernels[name] for name, (n, _) in
               kept.items()):
            return sum(us / n * kernels[name]
                       for name, (n, us) in kept.items()) / 1e3
    print(f"  device time of {first} not measured: a name kept fewer than "
          f"nine tenths of its records in each of {tries} windows")
    return None


def leaf_errors(lay, ref, got, leaves, rtol):
    """{leaf: (n entries beyond the bar's tolerance, max |diff| over the
    entries finite in both, leaf size)}, computed on the card."""
    import torch
    out = {}
    for n in leaves:
        o, w = lay.out_off[n]
        k = 1 if lay.out_kind[n] == "f" else 0
        x, y = ref[k][:, o:o + w], got[k][:, o:o + w]
        if k:
            d = ~torch.isclose(x, y, rtol=rtol, atol=0, equal_nan=True)
        else:
            d = x != y
        xd, yd = x.double(), y.double()
        fin = torch.isfinite(xd) & torch.isfinite(yd)
        diff = (xd - yd).abs()[fin]
        mad = float(diff.max()) if diff.numel() else 0.0
        out[n] = (int(d.sum()), mad, x.numel())
    return out


def check_and_time(tag, name, model, pi, oi, of, kernel, plain, leaves,
                   regime, errs, mode=()):
    """One stage: the plain version into (oi, of), the kernel into copies,
    from the same inputs; every leaf held to phase 3's bars (failures
    appended to ``errs``; K1 must equal its plain version); then both
    timed, beside the kernel's bound on these rows (kernels/bounds.py).
    ``mode`` is (pf, is_tumor_only) for K2/K3 in a normal-run mode."""
    import torch
    from uvc_tpu_torch.kernels import bounds
    lay = model.layout
    bnd = bounds.bound(name, lay, pi.shape[0], regime,
                       rescued=bool(mode) and mode[0] is not None)
    rtol = 1e-12 if regime == "f64" else 1e-5
    oi_k, of_k = oi.clone(), of.clone()
    plain(pi, oi, of, model, *mode)
    kernel(pi, oi_k, of_k, model, *mode)
    torch.cuda.synchronize()
    le = leaf_errors(lay, (oi, of), (oi_k, of_k), leaves, rtol)
    n_diff = sum(nd for nd, _, _ in le.values())
    mad = max(m for _, m, _ in le.values())
    for leaf, (nd, m, size) in le.items():
        if not nd:
            continue
        print(f"  {tag} {leaf}: {nd}/{size} entries differ, max |diff| {m}")
        if name == "capitals_vq":
            errs.append(f"{tag} {leaf}: {nd} entries differ from plain")
        elif lay.out_kind[leaf] == "f":
            errs.append(f"{tag} {leaf}: {nd} float entries beyond rtol "
                        f"{rtol}")
        elif m > 1 or (regime == "f64" and nd > 1e-4 * size):
            errs.append(f"{tag} {leaf}: {nd}/{size} int entries differ, "
                        f"max {m}")
    ms = cuda_ms(lambda: kernel(pi, oi_k, of_k, model, *mode), 20)
    plain_ms = cuda_ms(lambda: plain(pi, oi_k, of_k, model, *mode), 3)
    dev = None
    if pi.shape[0] == MAIN_ROWS:
        dev = device_ms(lambda: kernel(pi, oi_k, of_k, model, *mode), 200,
                        {f"{name}_kernel": 1})
    print(f"{tag}: {len(leaves)} leaves, {n_diff} entries differ, max "
          f"|diff| {mad}; kernel {ms:.4f} ms"
          + (f" (device {dev:.4f} ms)" if dev is not None else "")
          + f", plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}, {bnd['bytes'] / 1e6:.1f} MB)")
    return dict(max_abs_err=mad, n_diff=n_diff, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                rows=pi.shape[0], device_ms=dev)


def phase_kernels(dev):
    """Phase 3: every kernel against its plain version at 65,536 rows and
    at the main path's 128."""
    import numpy as np
    import torch
    from uvc_tpu_torch.backend import TorchModelBackend
    from uvc_tpu_torch.kernels import capitals_vq, dpv, qual_tail
    from uvc_tpu_torch.kernels.layout import K1_LEAVES, K2_LEAVES, K3_LEAVES
    from uvc_tpu_torch.model.example import (example_model_payload,
                                             packed_request)

    stages = (("capitals_vq", capitals_vq.capitals_vq,
               capitals_vq.capitals_vq_plain, K1_LEAVES),
              ("dpv", dpv.dpv, dpv.dpv_plain, K2_LEAVES),
              ("qual_tail", qual_tail.qual_tail, qual_tail.qual_tail_plain,
               K3_LEAVES))
    t0 = time.time()
    arrays, cand, cfg = example_model_payload(n_pos=TILE, seed=2,
                                              pad_to=TILE)
    reps = N_ROWS // TILE
    arrays = {k: np.concatenate([v] * reps, axis=0) for k, v in arrays.items()}
    cand = np.concatenate([cand] * reps, axis=0)
    print(f"phase 3: {N_ROWS}-row payload built in {time.time() - t0:.1f} s")
    res = {name: {} for name, *_ in stages}
    errs = []
    for regime in ("f64", "f32"):
        pi_np, _pf, ispec, _, _ = packed_request(arrays, cand, regime)
        model = TorchModelBackend(dev, regime).model(cfg)
        lay = model.bind(ispec)
        pi = torch.from_numpy(pi_np).to(dev)
        print(f"phase 3 {regime}: pi {tuple(pi.shape)} {pi.dtype}, "
              f"{pi.numel() * pi.element_size() / 1e6:.0f} MB")
        oi = torch.zeros((N_ROWS, lay.coi), dtype=model.regime.itype,
                         device=dev)
        of = torch.zeros((N_ROWS, lay.cof), dtype=model.regime.ftype,
                         device=dev)
        for name, kernel, plain, leaves in stages:
            res[name][regime] = check_and_time(
                f"phase 3 {regime} {name}", name, model, pi, oi, of, kernel,
                plain, leaves, regime, errs)
        pi_m = pi[:MAIN_ROWS].clone()
        oi_m, of_m = torch.zeros_like(oi[:MAIN_ROWS]), \
            torch.zeros_like(of[:MAIN_ROWS])
        for name, kernel, plain, leaves in stages:
            res[name][f"{regime} {MAIN_ROWS}"] = check_and_time(
                f"phase 3 {regime} {name} {MAIN_ROWS} rows", name, model,
                pi_m, oi_m, of_m, kernel, plain, leaves, regime, errs)
        del pi, oi, of, pi_m, oi_m, of_m
        torch.cuda.empty_cache()
    if errs:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(errs))
    return res


def run_cli(argv, stats=None):
    from uvc_tpu_torch.cli import uvc1
    rc = uvc1.run(argv, stats=stats)
    if rc != 0:
        raise RuntimeError(f"uvc1 {' '.join(argv)} returned {rc}")


def phase_goldens(d):
    """Phase 4: the CLI on the card against the committed goldens.  The
    family chain takes the device route in every region of each golden
    but the duplex one (golden_umi_duplex), which keeps the host route."""
    from uvc_tpu_torch import goldens
    inputs = goldens.build_inputs(d)
    for regime in ("f64", "f32"):
        routed = []
        for name in goldens.NAMES:
            out = os.path.join(d, f"{name}.{regime}.vcf.gz")
            stats = {}
            run_cli(inputs[name] + ["--device", "cuda", "--model-regime",
                                    regime, "-o", out], stats=stats)
            same, errs = goldens.compare(goldens.read_body(out),
                                         goldens.golden(name), regime)
            print(f"phase 4 {name} {regime}: {len(errs)} divergences; body "
                  f"byte-identical to the golden: {same}; family chain on "
                  f"the card in {stats['families_device']} of "
                  f"{stats['regions']} regions, pass C in "
                  f"{stats['pass_c_device']}")
            if errs:
                raise AssertionError(f"{name} {regime}:\n"
                                     + "\n".join(errs[:30]))
            if stats["pass_c_device"] != stats["regions"]:
                raise AssertionError(f"{name}: pass C on the card in "
                                     f"{stats['pass_c_device']} of "
                                     f"{stats['regions']} regions")
            want = 0 if name == "golden_umi_duplex" else stats["regions"]
            if stats["families_device"] != want:
                raise AssertionError(f"{name}: the family chain on the card "
                                     f"in {stats['families_device']} of "
                                     f"{stats['regions']} regions, not {want}")
            if want:
                routed.append(name)
        print(f"phase 4 {regime}: the family chain took the device route in "
              f"{', '.join(routed)}; golden_umi_duplex (duplex-flagged) "
              "kept the host route")


def phase_main_path(d):
    """Phase 5: the bench workload through uvc1 on the card, f32."""
    from uvc_tpu_torch import goldens, kernels
    from uvc_tpu_torch.family.device_chain import CHAIN_LAUNCHES
    from uvc_tpu_torch.pileup.device_pass_c import PASS_C_LAUNCHES
    t0 = time.time()
    fa, bam = goldens.build_bench_input(d)
    print(f"phase 5: bench BAM built in {time.time() - t0:.1f} s")
    nt = len(os.sched_getaffinity(0))
    out = os.path.join(d, "bench.cuda.vcf.gz")
    argv = ["-f", fa, "-t", str(nt), bam, "-o", out, "--device", "cuda",
            "--model-regime", "f32"]
    run_cli(argv)                       # warm-up: allocator, page cache
    runs = []
    kernels.reset_launches()
    for _ in range(3):
        stats = {}
        t0 = time.time()
        run_cli(argv, stats=stats)
        runs.append((time.time() - t0, stats))
    launches = dict(kernels.LAUNCHES)
    requests = sum(st["requests"] for _, st in runs)
    walls = [w for w, _ in runs]
    wall, stats = min(runs, key=lambda r: r[0])
    if stats["rows"] != MAIN_ROWS * stats["requests"]:
        raise AssertionError(f"{stats['rows']} rows in {stats['requests']} "
                             f"requests: not {MAIN_ROWS} rows a request")
    device_regions = sum(st["families_device"] for _, st in runs)
    pass_c_regions = sum(st["pass_c_device"] for _, st in runs)
    print(f"phase 5: {stats['reads']} reads at -t {nt}, 3 runs in "
          f"{' '.join(f'{w:.3f}' for w in walls)} s; best "
          f"{stats['reads'] / wall:.1f} reads/s; {stats['records']} records;"
          f" wall-s summed over workers prepare={stats['prepare']:.3f} "
          f"model={stats['model']:.3f} "
          f"emit={stats['emit']:.3f}; {stats['requests']} model requests of "
          f"{stats['rows']} rows in all per run; the family chain on the "
          f"card in {stats['families_device']} of {stats['regions']} "
          f"regions, pass C in {stats['pass_c_device']}; launches "
          f"{launches} over "
          f"{requests} requests; native host libraries {stats['native']}")
    if (requests < 1
            or any(launches[k] != requests
                   for k in ("capitals_vq", "dpv", "qual_tail"))
            or any(launches[k] != v * device_regions
                   for k, v in CHAIN_LAUNCHES.items())
            or any(launches[k] != v * pass_c_regions
                   for k, v in PASS_C_LAUNCHES.items())
            or any(v for k, v in launches.items()
                   if k not in ("capitals_vq", "dpv", "qual_tail")
                   and k not in CHAIN_LAUNCHES
                   and k not in PASS_C_LAUNCHES)):
        raise AssertionError(f"launches {launches} != {requests} model "
                             "requests: the main path skipped a kernel")
    if any(st["families_device"] != st["regions"] for _, st in runs):
        raise AssertionError("the main path kept the family chain on the "
                             "host in a region")
    if any(st["pass_c_device"] != st["regions"] for _, st in runs):
        raise AssertionError("the main path kept pass C on the host in a "
                             "region")
    ref_out = os.path.join(d, "bench.cpu.vcf.gz")
    t0 = time.time()
    run_cli(["-f", fa, "-t", str(nt), bam, "-o", ref_out, "--device", "cpu",
             "--model-regime", "f64"])
    got = goldens.read_body(out)
    same, errs = goldens.compare(got, goldens.read_body(ref_out), "f32")
    print(f"phase 5: cuda f32 VCF vs cpu f64 VCF ({time.time() - t0:.1f} s):"
          f" {len(errs)} divergences, byte-identical: {same}")
    if errs or not any(not l.startswith("#") for l in got):
        raise AssertionError("bench VCF off the f64 reference:\n"
                             + "\n".join(errs[:30]))
    return launches, stats, wall, walls


CHAIN_KERNELS = {   # record name: the chain kernel it belongs to
    "fc_offsets": "frag_merge", "fc_merge<false>": "frag_merge",
    "fc_merge<true>": "frag_merge", "fc_tail": "frag_merge",
    "fam_merge<false>": "fam_merge", "fam_merge<true>": "fam_merge",
    "fam_sweep2": "sweep2", "fam_m2": "sweep2", "fam_planes": "sweep2",
    "chain_scan": "chain_scan"}


def chain_bounds(sizes, counts):
    """Bytes each of the family chain's three kernels must move at least:
    each input read once, each output written once (the consensus rows
    and s2 rows that stay on the card: written once by their kernel, read
    once by the next)."""
    from uvc_tpu_torch.family import device_chain as dc
    n, S, R, F, NF, P = (sizes[k] for k in ("n", "S", "R", "F", "NF", "P"))
    n_out, n_mut, n_win, n_s2, n_g1, n_m2 = (
        int(counts[c]) for c in (dc.C_OUT, dc.C_MUT, dc.C_WIN, dc.C_S2,
                                 dc.C_G1, dc.C_M2))
    return {
        "frag_merge": 13 * n + 4 * (S + 1 + F + 1 + R) + 8 * F + 16 * P * 14
        + 4 * P + 4 * (3 * 28 + 224 + 14) * P + 25 * n_out + 16 * n_mut
        + 12 * n_win,
        "fam_merge": 24 * n_out + 4 * (NF + 1 + F) + 8 * NF + 16 * NF
        + 28 * n_s2 + 24 * n_g1 + 784 * P,
        "sweep2": 28 * n_s2 + 784 * P + 4 * P + 4 * 196 + 8 * dc.NPOW10
        + 784 * P + 1792 * P + 20 * n_m2}


def host_chain_input(ci, pass_c):
    """``ci`` with bg and aDP4 on the host: from the planes of the pass C
    launch the chain read them from (None: ``ci`` as it is)."""
    import dataclasses
    from uvc_tpu_torch.pileup import device_pass_c as dp
    if pass_c is None:
        return ci
    info, bg, _, _ = dp.host_planes(*dp.take(pass_c, pass_c["back"]), ci.P)
    return dataclasses.replace(
        ci, bg=bg, aDP4=info.aDPff + info.aDPfr + info.aDPrf + info.aDPrr)


def chain_inputs(argv):
    """The ChainInput of every region of a uvc1 run of ``argv``, bg and
    aDP4 on the host."""
    from uvc_tpu_torch.family import device_chain as dc
    cis = []
    real = dc.run

    def rec(ci, device, pass_c=None):
        out = real(ci, device, pass_c)
        cis.append(host_chain_input(ci, pass_c))
        return out

    dc.run = rec
    try:
        run_cli(argv)
    finally:
        dc.run = real
    return cis


def phase_family_chain(d, reps=5):
    """Phase 16: the family chain's kernels (family/device_chain.py) on
    the bench job's regions (phase 5's input in ``d``): each region's
    ChainInput from a card run of uvc1, the route's arrays held to the
    plain versions' (array for array), and per region: the route's host
    wall (staging, upload, launches, readback; median of ``reps``), each
    kernel's device time (torch.profiler, mean over ``reps`` launches,
    grouped into the three kernels), its bound in bytes and the share of
    it reached, the plain versions' and the host route's wall (native,
    one thread), and the copies' device time.  Then golden_small's region
    grouped into UMI families (device_chain.umi_variant, the family merge's
    k-way path) on the card, held to the plain and native chains."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from uvc_tpu_torch.family import device_chain as dc
    from uvc_tpu_torch.kernels.bounds import HBM_BYTES_PER_S
    from uvc_tpu_torch import goldens
    fa, bam = os.path.join(d, "bench.fa"), os.path.join(d, "bench.bam")
    cis = chain_inputs(["-f", fa, "-t", "4", bam, "-o", os.path.join(
        d, "bench.chain.vcf.gz"), "--device", "cuda", "--model-regime",
        "f64"])
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    # the family merge's k-way path (UMI families), which the bench job's
    # regions (one fragment a family) never take
    small = chain_inputs(goldens.build_inputs(d)["golden_small"] + [
        "-o", os.path.join(d, "small.chain.vcf.gz"), "--device", "cuda",
        "--model-regime", "f64"])
    for variant in dc.UMI_VARIANTS:
        ci = dc.umi_variant(small[0], variant)
        size = np.bincount(ci.fam_of_frag)
        got = dc.run(ci, cuda)
        if got is None:
            raise AssertionError(f"{variant}: the card's family chain "
                                 "flagged the region")
        diff = (dc.differences(dc.run(ci, cpu), got)
                + dc.differences(dc.native_chain(ci), got))
        if diff:
            raise AssertionError(f"{variant}: the card's family chain "
                                 f"differs from the plain/native in {diff}")
        print(f"phase 16 {variant}: {ci.n_fams} families, "
              f"{int((size > 1).sum())} of more than one fragment (up to "
              f"{int(size.max())}), {len(got.good[0])} good rows, "
              f"{len(got.m2[0])} m2 rows: the card's chain equals the plain "
              "and native chains array for array")
    out = []
    for i, ci in enumerate(cis):
        t0 = time.time()
        plain = dc.run(ci, cpu)
        plain_s = time.time() - t0
        t0 = time.time()
        native = dc.native_chain(ci)
        native_s = time.time() - t0
        walls = []
        for _ in range(reps):
            t0 = time.time()
            got = dc.run(ci, cuda)
            walls.append(time.time() - t0)
        diff = dc.differences(plain, got) + dc.differences(native, got)
        if diff:
            raise AssertionError(f"region {i}: the card's family chain "
                                 f"differs from the plain/native in {diff}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run_ = dc.launch(ci, cuda)
                dc.readback(run_)
        dev_us, copies = {}, {}
        for e in prof.key_averages():
            for k, grp in CHAIN_KERNELS.items():
                if k in e.key:
                    dev_us[k] = (e.count, e.device_time_total)
            for k in ("Memcpy HtoD", "Memcpy DtoH", "Memset"):
                if k in e.key:
                    c = copies.setdefault(k, [0, 0.0])
                    c[0] += e.count
                    c[1] += e.device_time_total
        run_ = dc.launch(ci, cuda)
        run_["stream"].synchronize()
        counts = dc.slot(run_, "counts").cpu().numpy()
        bounds = chain_bounds(run_["sizes"], counts)
        ms = {}
        for k, (cnt, us) in dev_us.items():
            ms[CHAIN_KERNELS[k]] = ms.get(CHAIN_KERNELS[k], 0.0) \
                + us / reps / 1e3
        row = dict(region=i, rows=len(ci.pos), P=ci.P, frags=ci.n_frags,
                   cons_rows=int(counts[dc.C_OUT]),
                   s2_rows=int(counts[dc.C_S2]),
                   route_wall_ms=sorted(walls)[len(walls) // 2] * 1e3,
                   plain_ms=plain_s * 1e3, native_ms=native_s * 1e3,
                   kernel_ms={k: round(v, 5) for k, v in ms.items()},
                   records={k: v[0] for k, v in dev_us.items()},
                   bound_ms={k: b / HBM_BYTES_PER_S * 1e3
                             for k, b in bounds.items()},
                   copies_ms={k: v[1] / reps / 1e3
                              for k, v in copies.items()},
                   copy_mb={"HtoD": run_["offs"][dc.SLOT["bdp"]] / 1e6})
        row["share"] = {k: row["bound_ms"][k] / ms[k] for k in bounds
                        if ms.get(k)}
        print(f"phase 16 region {i}: {json.dumps(row)}")
        out.append(row)
    return out


def pass_c_bounds(sizes):
    """Bytes pass C must move at least: each event's 18 staged bytes and
    each read's row (N_RF + 6 int32) read once, the thresholds, baq and
    baq2 (N_TH + 2 int32 a position) read once, the planes (34 int32 and 5
    int64 a (pos, sym)) and aDP4 (int64) written once."""
    from uvc_tpu_torch.ops.native_rowpile import N_RF, N_TH
    n, R, P = sizes["n"], sizes["R"], sizes["P"]
    return (18 * n + 4 * (N_RF + 6) * R + 4 * (N_TH + 2) * P
            + (4 * 34 + 8 * 5 + 8) * P * 14)


def _differing(a, b):
    """Entries in which two arrays differ (all of them where the shapes
    or dtypes differ)."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return max(a.size, b.size)
    return int((a != b).sum())


def pass_c_differing(want, got):
    """Differing entries of two pass C results (info, bg, a1, a2)."""
    from uvc_tpu_torch.pileup import engine_bq
    n = sum(_differing(getattr(want[0], nm), getattr(got[0], nm))
            for nm in engine_bq.SegInfo.names)
    return n + sum(_differing(a, b) for a, b in zip(want[1:], got[1:]))


def phase_pass_c(d, reps=5):
    """Phase 17: pass C on the card (pileup/device_pass_c.py) on the bench
    job's regions (phase 5's input in ``d``).  One uvc1 run on the card
    records each region's pass C arguments and the chain's input and
    output where the chain read pass C's columns; per region: the
    kernel's planes and aDP4 against the plain version's, the route's
    result against the native pass's, the chain's arrays against the
    chain run on the native pass's bg and aDP4 (differing entries: 0
    each), the route's host wall (median of ``reps``), the kernels' device
    time (torch.profiler, mean over ``reps``), their bound in bytes and the
    share reached, the plain version's and the native pass's wall."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from uvc_tpu_torch.family import device_chain as dc
    from uvc_tpu_torch.kernels.bounds import HBM_BYTES_PER_S
    from uvc_tpu_torch.pileup import device_pass_c as dp
    from uvc_tpu_torch.pileup import engine_bq
    fa, bam = os.path.join(d, "bench.fa"), os.path.join(d, "bench.bam")
    args_of, chains = [], []
    real_route, real_run = dp.route, dc.run

    def rec_route(*args):
        pc = real_route(*args)
        args_of.append((args, pc.route))
        return pc

    def rec_run(ci, device, pass_c=None):
        out = real_run(ci, device, pass_c)
        chains.append((ci, pass_c is not None, out))
        return out

    dp.route, dc.run = rec_route, rec_run
    try:
        run_cli(["-f", fa, "-t", "4", bam, "-o", os.path.join(
            d, "bench.pass_c.vcf.gz"), "--device", "cuda", "--model-regime",
            "f64"])
    finally:
        dp.route, dc.run = real_route, real_run
    if len(args_of) != 4 or any(r != "device" for _, r in args_of):
        raise AssertionError(f"pass C routes {[r for _, r in args_of]}: "
                             "not the card in the bench job's 4 regions")
    cuda, out = torch.device("cuda", 0), []
    for i, (args, _) in enumerate(args_of):
        t0 = time.time()
        st = dp.stage(*args)
        err, (p_out, p_big, p_adp4) = dp.scatter_plain(
            *st, dp.params(st[0], args[7]))
        plain_s = time.time() - t0
        t0 = time.time()
        native = engine_bq.pass_c_scatter(*args)
        native_s = time.time() - t0
        run_ = dp.launch(*args, cuda, sync_each=True)
        k_out, k_big = dp.take(run_, dp.readback(run_))
        o = run_["offs"][dp.SLOT["adp4"]]
        k_adp4 = run_["dev"][o:o + 8 * len(p_adp4)].view(torch.int64).cpu()
        walls = []
        for _ in range(reps):
            t0 = time.time()
            got = dp.result(dp.PassC(args, "device",
                                     run=dp.launch(*args, cuda)))
            walls.append(time.time() - t0)
        diff = dict(plain=err + _differing(p_out.numpy(), k_out)
                    + _differing(p_big.numpy(), k_big)
                    + _differing(p_adp4.numpy(), k_adp4.numpy()),
                    native=pass_c_differing(native, got))
        chain = [(ci, o_) for ci, shared, o_ in chains
                 if shared and ci.pos is args[0].pos]
        if len(chain) != 1 or chain[0][1] is None:
            raise AssertionError(f"region {i}: the chain did not run on "
                                 "pass C's columns")
        ci, got_chain = chain[0]
        info = native[0]
        host = dc.run(dataclasses.replace(
            ci, bg=native[1],
            aDP4=info.aDPff + info.aDPfr + info.aDPrf + info.aDPrr), cuda)
        diff["chain"] = len(dc.differences(host, got_chain))
        if any(diff.values()):
            raise AssertionError(f"region {i}: pass C on the card differs "
                                 f"({diff}: differing entries, the chain's "
                                 "differing arrays)")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                dp.readback(dp.launch(*args, cuda))
        dev_us, copies = {}, {}
        for e in prof.key_averages():
            for k in ("pc_scatter", "pc_adp4"):
                if k in e.key:
                    dev_us[k] = (e.count, e.device_time_total)
            for k in ("Memcpy HtoD", "Memcpy DtoH", "Memset"):
                if k in e.key:
                    c = copies.setdefault(k, [0, 0.0])
                    c[0] += e.count
                    c[1] += e.device_time_total
        ms = sum(us for _, us in dev_us.values()) / reps / 1e3
        sizes = run_["sizes"]
        bound = pass_c_bounds(sizes) / HBM_BYTES_PER_S * 1e3
        row = dict(region=i, events=sizes["n"], reads=sizes["R"],
                   P=sizes["P"], differing=diff,
                   route_wall_ms=sorted(walls)[len(walls) // 2] * 1e3,
                   plain_ms=plain_s * 1e3, native_ms=native_s * 1e3,
                   kernel_ms=round(ms, 5),
                   records={k: v[0] for k, v in dev_us.items()},
                   bound_ms=bound, share=bound / ms if ms else None,
                   copies_ms={k: v[1] / reps / 1e3
                              for k, v in copies.items()},
                   copy_mb={"HtoD": run_["offs"][dp.SLOT["out"]] / 1e6,
                            "DtoH": run_["planes"].numel() / 1e6})
        print(f"phase 17 region {i}: {json.dumps(row)}")
        out.append(row)
    return out


def phase_rescued_kernels(dev):
    """Phase 6: K1-K3 on the normal run's requests against plain, at
    65,536 rows and at the main path's 128."""
    import numpy as np
    import torch
    from uvc_tpu_torch.backend import TorchModelBackend
    from uvc_tpu_torch.kernels import capitals_vq, dpv, qual_tail
    from uvc_tpu_torch.kernels.layout import K1_LEAVES, K2_LEAVES, K3_LEAVES
    from uvc_tpu_torch.model.example import (example_model_payload,
                                             packed_request, seeded_tpfa)

    arrays, cand, cfg = example_model_payload(n_pos=TILE, seed=2,
                                              pad_to=TILE)
    arrays, tp_d, tp_q = seeded_tpfa(arrays, 6)
    reps = N_ROWS // TILE
    arrays = {k: np.concatenate([v] * reps, axis=0) for k, v in arrays.items()}
    cand = np.concatenate([cand] * reps, axis=0)
    tp_d = np.concatenate([tp_d] * reps, axis=0)
    tp_q = np.concatenate([tp_q] * reps, axis=0)
    stages = (("dpv", dpv.dpv, dpv.dpv_plain, K2_LEAVES),
              ("qual_tail", qual_tail.qual_tail, qual_tail.qual_tail_plain,
               K3_LEAVES))
    res, errs = {}, []
    for regime in ("f64", "f32"):
        for mode in ("rescued", "normal"):
            td, tq = (tp_d, tp_q) if mode == "rescued" else (None, None)
            pi_np, pf_np, ispec, _, _ = packed_request(
                arrays, cand, regime, td, tq, is_tumor_only=False)
            model = TorchModelBackend(dev, regime).model(cfg)
            lay = model.bind(ispec)
            pi = torch.from_numpy(pi_np).to(dev)
            pf = None if pf_np is None else torch.from_numpy(pf_np).to(dev)
            oi = torch.zeros((N_ROWS, lay.coi), dtype=model.regime.itype,
                             device=dev)
            of = torch.zeros((N_ROWS, lay.cof), dtype=model.regime.ftype,
                             device=dev)
            for rows in (N_ROWS, MAIN_ROWS):
                p_i = pi[:rows].clone()
                p_f = None if pf is None else pf[:rows].clone()
                o_i, o_f = oi[:rows].clone(), of[:rows].clone()
                # K1 takes no mode; it reads the normal run's planes
                res[("capitals_vq", regime, mode, rows)] = check_and_time(
                    f"phase 6 {regime} {mode} capitals_vq {rows} rows",
                    "capitals_vq", model, p_i, o_i, o_f,
                    capitals_vq.capitals_vq, capitals_vq.capitals_vq_plain,
                    K1_LEAVES, regime, errs)
                for name, kernel, plain, leaves in stages:
                    res[(name, regime, mode, rows)] = check_and_time(
                        f"phase 6 {regime} {mode} {name} {rows} rows", name,
                        model, p_i, o_i, o_f, kernel, plain, leaves, regime,
                        errs, (p_f, False))
                del p_i, p_f, o_i, o_f
            del pi, pf, oi, of
            torch.cuda.empty_cache()
    if errs:
        raise AssertionError("normal-run kernels disagree with their plain "
                             "versions:\n" + "\n".join(errs))
    return res


def run_uvctn(argv, stats=None):
    from uvc_tpu_torch.cli import uvctn
    rc = uvctn.run(argv, stats=stats)
    if rc != 0:
        raise RuntimeError(f"uvctn {' '.join(argv)} returned {rc}")


def phase_golden_tn(d):
    """Phase 7: golden_tn through uvctn on the card, both regimes."""
    from uvc_tpu_torch import goldens
    argv = goldens.build_tn_inputs(d)
    for regime in ("f64", "f32"):
        pref = argv[3] + regime
        stats = {}
        run_uvctn(argv[:3] + [pref] + argv[4:] + [
            "--device", "cuda", "--model-regime", regime], stats=stats)
        same, errs = goldens.compare(
            goldens.read_body(pref + ".normal.vcf.gz"),
            goldens.golden("golden_tn"), regime)
        print(f"phase 7 golden_tn {regime}: {len(errs)} divergences; body "
              f"byte-identical to the golden: {same}; normal run "
              f"{stats['normal']['requests']} requests "
              f"({stats['normal']['rescued_requests']} rescued)")
        if errs or not stats["normal"]["rescued_requests"]:
            raise AssertionError(f"golden_tn {regime}:\n"
                                 + "\n".join(errs[:30]))


def phase_tn_main_path(d):
    """Phase 8: the tumor-normal pair at bench scale through uvctn, f32."""
    from uvc_tpu_torch import goldens, kernels
    t0 = time.time()
    fa, tbam, nbam = goldens.build_tn_bench_inputs(d)
    print(f"phase 8: tumor and normal BAMs built in {time.time() - t0:.1f} s")
    nt = len(os.sched_getaffinity(0))
    pref = os.path.join(d, "tn_bench.cuda")
    threads = ["--tumor-params", f"-t {nt}", "--normal-params", f"-t {nt}"]
    argv = [fa, tbam, nbam, pref, *threads, "--device", "cuda",
            "--model-regime", "f32"]
    run_uvctn(argv)                     # warm-up
    runs = []
    kernels.reset_launches()
    for _ in range(3):
        stats = {}
        t0 = time.time()
        run_uvctn(argv, stats=stats)
        runs.append((time.time() - t0, stats))
    launches = dict(kernels.LAUNCHES)
    requests = sum(st[k]["requests"] for _, st in runs
                   for k in ("tumor", "normal"))
    rescued = sum(st["normal"]["rescued_requests"] for _, st in runs)
    walls = [w for w, _ in runs]
    wall, stats = min(runs, key=lambda r: r[0])
    reads = stats["tumor"]["reads"] + stats["normal"]["reads"]
    print(f"phase 8: {reads} reads (tumor {stats['tumor']['reads']}, normal "
          f"{stats['normal']['reads']}) at -t {nt}, 3 runs in "
          f"{' '.join(f'{w:.3f}' for w in walls)} s; best "
          f"{reads / wall:.1f} reads/s for the pair; normal run: "
          f"{stats['normal']['records']} records, "
          f"{stats['normal']['requests']} requests "
          f"({stats['normal']['rescued_requests']} rescued), wall-s summed "
          f"over workers prepare="
          f"{stats['normal']['prepare']:.3f} model="
          f"{stats['normal']['model']:.3f}; launches {launches} over "
          f"{requests} requests, {rescued} rescued")
    model_kernels = ("capitals_vq", "dpv", "qual_tail")
    if (requests < 1 or rescued < 1
            or any(launches[k] != requests for k in model_kernels)
            or launches["dpv_rescued"] != rescued
            or launches["qual_tail_rescued"] != rescued):
        raise AssertionError(f"launches {launches} vs {requests} requests, "
                             f"{rescued} rescued: the main path skipped a "
                             "kernel")
    ref = os.path.join(d, "tn_bench.cpu")
    t0 = time.time()
    run_uvctn([fa, tbam, nbam, ref, *threads, "--device", "cpu",
               "--model-regime", "f64"])
    got = goldens.read_body(pref + ".normal.vcf.gz")
    same, errs = goldens.compare(got, goldens.read_body(ref + ".normal.vcf.gz"),
                                 "f32")
    print(f"phase 8: cuda f32 normal VCF vs cpu f64 ({time.time() - t0:.1f} "
          f"s): {len(errs)} divergences, byte-identical: {same}; "
          f"{sum(not l.startswith('#') for l in got)} records")
    if errs or not any("\tPASS\t" in l for l in got):
        raise AssertionError("tumor-normal VCF off the f64 reference:\n"
                             + "\n".join(errs[:30]))
    return launches, stats, wall, walls, reads


def library_sort(buf, nkeys):
    """dc_sort's library route, a yardstick that nothing in the port
    calls: sort the int32 table ``buf`` [A, N] in place by its first
    ``nkeys`` rows, stably, with the key columns packed into the 64-bit
    words that ``sort_plan`` lays out (from the key ranges, read back
    once, as dc_sort reads them), one stable ``torch.sort`` a word from
    the least significant, then one gather of the table's columns.
    torch.sort has no unsigned 64-bit sort, so each word's top bit is
    flipped first: that maps unsigned order onto int64 order."""
    import torch
    from uvc_tpu_torch.ops import device_consensus as tdc
    lo, hi = torch.stack(torch.aminmax(buf[:nkeys], dim=1)).cpu().tolist()
    perm = None
    for word in tdc.sort_plan(lo, hi).words:
        w = torch.zeros(buf.shape[1], dtype=torch.int64, device=buf.device)
        for k, shift, mn in word:
            w |= (buf[k].long() - mn) << shift
        w ^= torch.iinfo(torch.int64).min
        if perm is None:
            perm = torch.sort(w, stable=True).indices
        else:
            perm = perm[torch.sort(w[perm], stable=True).indices]
    if perm is not None:
        buf.copy_(buf[:, perm])


# dc_segments' records in a torch.profiler trace of one call (both stages,
# stage 2 on stage 1's scratch), for device_ms: this tree's two passes, the
# tail of the stage-2 table and the one memset of the scratch ...
SEG_FAMILY = {"seg_pass<1>": 1, "seg_pass<2>": 1, "seg_tail": 1,
              "Memset (Device)": 1}
# ... and the seven kernels of the design before the one-pass stages (a
# count, a one-block scan and a rank a stage, and keys2), no memset
SEG_FAMILY_BEFORE = {"seg_count": 2, "seg_scan": 2, "seg_unique": 1,
                     "keys2": 1, "seg_groups": 1}


def seg_family(tdc):
    """The SEG_FAMILY entry that times the dc_segments of the checkout
    whose ops/device_consensus module is ``tdc``: the family its CUDA
    source defines."""
    src = os.path.join(os.path.dirname(os.path.dirname(tdc.__file__)),
                       "kernels", "csrc", "device_consensus.cu")
    with open(src) as fh:
        return SEG_FAMILY if "seg_pass(" in fh.read() else SEG_FAMILY_BEFORE


def b1_tables():
    """(random, wide) event columns of phase 9's 2^20-row tables (seed 9):
    the random one as the bench's streams are laid out, the wide one with
    full-range int32 group and pos and negative values."""
    import numpy as np
    rng = np.random.default_rng(9)
    n = (1 << 20) - 4096
    cols = (rng.integers(0, n // 2, n), rng.integers(0, 30000, n),
            rng.integers(0, 14, n), rng.integers(0, 60, n))
    i32 = (-2**31, 2**31)
    wide = (rng.integers(*i32, n), rng.integers(*i32, n),
            rng.integers(0, 14, n), rng.integers(-60, 60, n))
    return cols, wide


def seg_times(seg, s1, s2, mode_sum, ovr, reps, family=None):
    """(CUDA-event ms, device ms or None) of one call's two stages of
    ``seg`` (dc_segments or its plain version) from the sorted tables
    ``s1`` and ``s2``, stage 2 on stage 1's scratch where ``seg`` takes
    one (the program's way; the design before the one-pass stages had
    none).  The
    device time (``device_ms`` over 200 calls) sums the records of
    ``family`` (a SEG_FAMILY entry), and is taken only where one is
    given."""
    import inspect
    import torch
    N, kw = s1.shape[1], dict(dtype=torch.int32, device=s1.device)
    out_u, out_c = torch.zeros((4, N), **kw), torch.zeros((6, N), **kw)
    buf2, counts = torch.empty((9, N), **kw), torch.zeros(2, **kw)
    pass_on = "scratch" in inspect.signature(seg).parameters

    def call():
        scratch = seg(1, s1, mode_sum, ovr, out_u, buf2, counts)
        seg(2, s2, mode_sum, ovr, out_c, None, counts,
            **({"scratch": scratch} if pass_on else {}))
    ms = cuda_ms(call, reps)
    return ms, (device_ms(call, 200, family) if family else None)


def b1_compare(dev, cols, mode, ovr, reps, repeats=0):
    """dc_sort and dc_segments against their plain versions on the card
    from the stage-1 table of ``cols``, and the two sorts' library route
    (``library_sort``) against dc_sort_plain.  Returns a dict: differing
    entries (``n_diff``), kernel and plain ms of each family (the sorts'
    less the table copies before them), dc_segments' device ms, N, the
    kernel's two sort plans, the counts of b1_bounds (n_rows, n_uniq,
    n_pos, n_grp), the library route's differing entries and ms, and,
    over ``repeats`` more runs of dc_segments from the same sorted tables,
    the entries that differ from the plain version's and from the first
    run's (``repeat_diff``).  The first kernel run's stage 2 zeroes its own
    scratch; the timed calls and the repeats hand it stage 1's, as the
    program does."""
    import torch
    from uvc_tpu_torch.ops import device_consensus as tdc
    table = torch.from_numpy(tdc.stage1_table(*cols)).to(dev)
    N = table.shape[1]
    kw = dict(dtype=torch.int32, device=dev)
    mode_sum = mode == "sum"
    runs = {}
    buf1, buf2 = table.clone(), torch.empty((9, N), **kw)
    for impl in ("kernel", "plain"):
        sort = tdc.dc_sort if impl == "kernel" else tdc.dc_sort_plain
        seg = tdc.dc_segments if impl == "kernel" else tdc.dc_segments_plain
        buf1.copy_(table)
        out_u, out_c = torch.zeros((4, N), **kw), torch.zeros((6, N), **kw)
        counts = torch.zeros(2, **kw)
        plans = [sort(buf1, tdc.NKEYS1)]
        s1 = buf1.clone()
        seg(1, buf1, mode_sum, ovr, out_u, buf2, counts)
        t2 = buf2.clone()
        plans.append(sort(buf2, tdc.NKEYS2))
        s2 = buf2.clone()
        seg(2, buf2, mode_sum, ovr, out_c, None, counts)
        torch.cuda.synchronize()
        n = reps if impl == "kernel" else 2
        ms_sort = cuda_ms(lambda: (buf1.copy_(table), sort(buf1, tdc.NKEYS1),
                                   buf2.copy_(t2), sort(buf2, tdc.NKEYS2)), n)
        ms_copy = cuda_ms(lambda: (buf1.copy_(table), buf2.copy_(t2)), n)
        ms_seg, dev_seg = seg_times(seg, s1, s2, mode_sum, ovr, n,
                                    SEG_FAMILY if impl == "kernel" else None)
        runs[impl] = dict(outs=[s1, t2, s2, out_u, out_c, counts],
                          sort_ms=max(ms_sort - ms_copy, 0.0), seg_ms=ms_seg,
                          seg_device_ms=dev_seg, plans=plans, copy_ms=ms_copy)
    k, p = runs["kernel"], runs["plain"]
    n_diff = sum(int((a != b).sum()) for a, b in zip(k["outs"], p["outs"]))
    n_uniq, n_grp = (int(x) for x in k["outs"][5].cpu())
    # the ok rows each stage reads in full
    n_rows, n_pos = (int((t[0] == 0).sum()) for t in (table, k["outs"][2]))
    # dc_segments again and again from the sorted tables: the look-back's
    # ranks must come out the same every time
    s1, t2, s2, out_u, out_c, counts = p["outs"]
    first, repeat_diff = None, []
    for _ in range(repeats):
        o = [torch.zeros((4, N), **kw), torch.empty((9, N), **kw),
             torch.zeros((6, N), **kw), torch.zeros(2, **kw)]
        scratch = tdc.dc_segments(1, s1, mode_sum, ovr, o[0], o[1], o[3])
        tdc.dc_segments(2, s2, mode_sum, ovr, o[2], None, o[3], scratch)
        first = first or o
        repeat_diff.append(sum(
            int((a != b).sum()) + int((a != c).sum())
            for a, b, c in zip(o, (out_u, t2, out_c, counts), first)))
    # the library route, from the plain run's tables, timed as the kernel
    buf1.copy_(table)
    library_sort(buf1, tdc.NKEYS1)
    buf2.copy_(t2)
    library_sort(buf2, tdc.NKEYS2)
    lib_diff = int((buf1 != s1).sum()) + int((buf2 != s2).sum())
    ms_lib = cuda_ms(lambda: (
        buf1.copy_(table), library_sort(buf1, tdc.NKEYS1),
        buf2.copy_(t2), library_sort(buf2, tdc.NKEYS2)), reps)
    return dict(n_diff=n_diff, sort_ms=k["sort_ms"], seg_ms=k["seg_ms"],
                seg_device_ms=k["seg_device_ms"], sort_plain_ms=p["sort_ms"],
                seg_plain_ms=p["seg_ms"], N=N, plans=k["plans"],
                n_rows=n_rows, n_uniq=n_uniq, n_pos=n_pos, n_grp=n_grp,
                lib_diff=lib_diff,
                lib_ms=max(ms_lib - k["copy_ms"], 0.0),
                repeat_diff=repeat_diff)


def b1_bounds(N, n_rows, n_uniq, n_pos, n_grp):
    """{family: (bound ms, bound_by, bytes)} of one consensus call's
    kernels on an N-row table with n_rows ok rows, n_uniq unique rows, of
    which n_pos have a value above 0, and n_grp groups, at 3.35 TB/s
    (their integer work is far below the card's rate).  Each sort reads
    and writes its table (6 and 9 int32 rows of N).  The segments count
    the columns each stage must move; a row that is not ok joins no
    segment, so only its flag must be read.  Stage 1 reads inval (N) and
    g, p, s and v of the ok rows (4 n_rows), and writes the unique rows
    (4 n_uniq) and the stage-2 table (9 N); stage 2 reads c_inv (N) and
    g, p, st, s and v of its ok rows (5 n_pos), and writes the consensus
    rows (6 n_grp)."""
    from uvc_tpu_torch.kernels.bounds import HBM_BYTES_PER_S
    sort_b = 2 * 4 * N * (6 + 9)
    seg_b = 4 * (N + 4 * n_rows + 4 * n_uniq + 9 * N
                 + N + 5 * n_pos + 6 * n_grp)
    return {name: (b / HBM_BYTES_PER_S * 1e3, "bytes", b)
            for name, b in (("dc_sort", sort_b), ("dc_segments", seg_b))}


def b1_bounds_of(r):
    """b1_bounds of one b1_compare result."""
    return b1_bounds(r["N"], r["n_rows"], r["n_uniq"], r["n_pos"], r["n_grp"])


def print_b1(tag, r):
    bound = b1_bounds_of(r)["dc_segments"][0]
    dev = r["seg_device_ms"]
    share = (f"{bound / r['seg_ms']:.1%} of it by events"
             + (f", {bound / dev:.1%} by device time" if dev else ""))
    print(f"{tag}: {r['n_diff']} entries differ; dc_sort x2 "
          f"{r['sort_ms']:.4f} ms (plain {r['sort_plain_ms']:.4f}, library "
          f"route {r['lib_ms']:.4f} with {r['lib_diff']} entries differing "
          f"from plain), dc_segments x2 {r['seg_ms']:.4f} ms (device "
          + (f"{dev:.4f}" if dev else "not measured")
          + f", plain {r['seg_plain_ms']:.4f}); n_rows {r['n_rows']}, n_uniq "
          f"{r['n_uniq']}, n_pos {r['n_pos']}, n_grp {r['n_grp']}; "
          f"dc_segments bound {bound:.4f} ms (bytes of the columns each "
          f"stage moves): {share}")
    if r["repeat_diff"]:
        print(f"  dc_segments x{len(r['repeat_diff'])} more runs: entries "
              f"differing from plain and from the first run "
              f"{r['repeat_diff']}")
    for stage, plan in zip((1, 2), r["plans"]):
        print(f"  dc_sort stage {stage} plan: {plan}")


def b1_failed(r):
    return r["n_diff"] or r["lib_diff"] or any(r["repeat_diff"])


def phase_b1(dev, d, gate_off_body, gate_off_wall):
    """Phase 9: B1 kernels against plain, then the gated main path; the
    largest real stream it sent is written to ``d``/b1_real_stream.npz
    for phase 10."""
    import numpy as np
    from uvc_tpu_torch import goldens, kernels
    from uvc_tpu_torch.ops import device_consensus as tdc
    res, errs = {}, []
    cols, wide = b1_tables()
    for mode in ("max", "sum"):
        for ovr in (False, True):
            r = b1_compare(dev, cols, mode, ovr, 5,
                           20 if (mode, ovr) == ("max", True) else 0)
            res[("random", mode, ovr)] = r
            print_b1(f"phase 9 random N={r['N']} {mode} ovr={ovr}", r)
            if b1_failed(r):
                errs.append(f"random {mode} ovr={ovr}: {r['n_diff']} entries "
                            f"differ, library route {r['lib_diff']}, "
                            f"repeats {r['repeat_diff']}")
    r = b1_compare(dev, wide, "sum", True, 5)
    res[("wide", "sum", True)] = r
    print_b1(f"phase 9 wide keys N={r['N']} sum ovr=True", r)
    if b1_failed(r) or any(len(p.words) < 2 for p in r["plans"]):
        errs.append(f"wide keys: {r['n_diff']} entries differ, library "
                    f"route {r['lib_diff']}, plans "
                    f"{[str(p) for p in r['plans']]}")

    # the gated main path, recording its largest real fragment stream
    fa, bam = os.path.join(d, "bench.fa"), os.path.join(d, "bench.bam")
    nt = len(os.sched_getaffinity(0))
    out = os.path.join(d, "bench.devprep.vcf.gz")
    argv = ["-f", fa, "-t", str(nt), bam, "-o", out, "--device", "cuda",
            "--model-regime", "f32"]
    orig = tdc.device_reduce_consensus
    biggest = []

    def recording(group, pos, sym, val, P, mode, link_m_overridden):
        if not biggest or len(group) > len(biggest[0][0][0]):
            biggest[:] = [((np.array(group), np.array(pos), np.array(sym),
                            np.array(val)), mode, link_m_overridden)]
        return orig(group, pos, sym, val, P, mode, link_m_overridden)
    os.environ["UVC_TPU_DEVICE_PREPARE"] = "1"
    tdc.device_reduce_consensus = recording
    try:
        calls0, rows0 = tdc.STATS["calls"], tdc.STATS["rows"]
        kernels.reset_launches()
        t0 = time.time()
        stats = {}
        run_cli(argv, stats=stats)
        wall = time.time() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        tdc.device_reduce_consensus = orig
        del os.environ["UVC_TPU_DEVICE_PREPARE"]
    calls = tdc.STATS["calls"] - calls0
    rows = tdc.STATS["rows"] - rows0
    same = goldens.read_body(out) == gate_off_body
    print(f"phase 9 gate on: {stats['reads']} reads in {wall:.3f} s "
          f"({stats['reads'] / wall:.1f} reads/s; gate off, phase 5 best: "
          f"{gate_off_wall:.3f} s); {calls} consensus calls over {rows} event "
          f"rows; launches dc_sort={launches['dc_sort']} "
          f"dc_segments={launches['dc_segments']}; body byte-identical to "
          f"gate off: {same}")
    if (calls < 1 or launches["dc_sort"] != 2 * calls
            or launches["dc_segments"] != 2 * calls):
        errs.append(f"{calls} consensus calls but launches {launches}")
    if not same:
        errs.append("the gate-on VCF body differs from the gate-off body")
    (rcols, rmode, rovr), = biggest
    stream = os.path.join(d, "b1_real_stream.npz")
    np.savez(stream, *rcols, mode=rmode, ovr=rovr)
    r = b1_compare(dev, rcols, rmode, rovr, 20, 20)
    res[("real", rmode, rovr)] = r
    print_b1(f"phase 9 real stream of {len(rcols[0])} rows (N={r['N']}, "
             f"{rmode}, ovr={rovr})", r)
    if b1_failed(r):
        errs.append(f"real stream: {r['n_diff']} entries differ, library "
                    f"route {r['lib_diff']}, repeats {r['repeat_diff']}")
    # one consensus call's cost on that stream, by part (host clock)
    t0 = time.perf_counter()
    for _ in range(3):
        tdc.stage1_table(*rcols)
    table_ms = (time.perf_counter() - t0) * 1e3 / 3
    t0 = time.perf_counter()
    for _ in range(3):
        tdc.device_reduce_consensus(*rcols, 0, rmode, rovr)
    call_ms = (time.perf_counter() - t0) * 1e3 / 3
    kern_ms = r["sort_ms"] + r["seg_ms"]
    print(f"phase 9 one consensus call on the real stream: {call_ms:.3f} ms "
          f"in all; host table {table_ms:.3f} ms, kernels {kern_ms:.3f} ms, "
          f"the rest (copies, allocation, launches, slicing) "
          f"{call_ms - table_ms - kern_ms:.3f} ms")
    if errs:
        raise AssertionError("B1:\n" + "\n".join(errs))
    return res, launches, calls, wall, dict(call_ms=call_ms,
                                            table_ms=table_ms), stream


def b1_segment_times(dev, stream):
    """This checkout's dc_segments, both stages of a call, on phase 9's
    random 2^20 table (max, link_m_overridden) and on the real stream
    saved at ``stream``: {"N2e20" / "real": (event ms over 20 calls,
    device ms over 200 of the family the checkout's source defines,
    ``seg_family``)}.  The sorted tables come from the plain versions, so
    two checkouts time the same inputs."""
    import numpy as np
    import torch
    from uvc_tpu_torch.ops import device_consensus as tdc
    family = seg_family(tdc)
    z = np.load(stream)
    tables = {"N2e20": (b1_tables()[0], "max", True),
              "real": (tuple(z[f"arr_{i}"] for i in range(4)),
                       str(z["mode"]), bool(z["ovr"]))}
    out = {}
    for name, (cols, mode, ovr) in tables.items():
        s1 = torch.from_numpy(tdc.stage1_table(*cols)).to(dev)
        N, kw = s1.shape[1], dict(dtype=torch.int32, device=dev)
        tdc.dc_sort_plain(s1, tdc.NKEYS1)
        s2, counts = torch.empty((9, N), **kw), torch.zeros(2, **kw)
        tdc.dc_segments_plain(1, s1, mode == "sum", ovr,
                              torch.zeros((4, N), **kw), s2, counts)
        tdc.dc_sort_plain(s2, tdc.NKEYS2)
        out[name] = seg_times(tdc.dc_segments, s1, s2, mode == "sum", ovr,
                              20, family)
    return out


def phase_parent(parent, stream):
    """Phase 10: K1-K3 and dc_segments of the checkout ``parent`` and of
    this tree timed by kernel_times.py in turns (parent, change, change,
    parent), one process each, dc_segments on the real stream saved at
    ``stream``.  Returns [(label, {"<kernel> <regime> <rows>": ms}, {"N2e20"
    / "real": (event ms, device ms)})]."""
    turns = []
    for label, tree in (("parent", parent), ("change", REPO),
                        ("change", REPO), ("parent", parent)):
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "kernel_times.py"),
             "--checkout", tree, "--label", label, "--b1", stream],
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"kernel_times.py --checkout {tree} returned "
                               f"{r.returncode}:\n{r.stderr[-3000:]}")
        lines = r.stdout.strip().splitlines()
        print("\n".join(f"phase 10 {l}" for l in lines[:-1]))
        res = json.loads(lines[-1])
        turns.append((label, res["ms"], res["b1"]))
    for key in turns[0][1]:
        p = [ms[key] for lab, ms, _ in turns if lab == "parent"]
        c = [ms[key] for lab, ms, _ in turns if lab == "change"]
        print(f"phase 10 {key}: parent {p[0]:.4f} / {p[1]:.4f} ms, change "
              f"{c[0]:.4f} / {c[1]:.4f} ms, {sum(p) / sum(c):.2f}x")
    for key in turns[0][2]:
        for i, what in ((0, "events"), (1, "device")):
            p = [b1[key][i] for lab, _, b1 in turns if lab == "parent"]
            c = [b1[key][i] for lab, _, b1 in turns if lab == "change"]
            print(f"phase 10 dc_segments {key} ({what}): parent {p} ms, "
                  f"change {c} ms")
    return turns


def k1_was(turns):
    """K1's row's "was" (the parent's K1 times, both turns) and
    "in_turns" (this tree's), from phase 10, keyed "<regime>_<rows>"."""
    if not turns:
        return None, None
    out = {"parent": {}, "change": {}}
    for label, ms, _ in turns:
        for key, v in ms.items():
            name, reg, rows = key.split()
            if name == "capitals_vq":
                out[label].setdefault(f"{reg}_{rows}", []).append(v)
    return out["parent"], out["change"]


def seg_was(turns):
    """dc_segments' row's "was" keys from phase 10: the parent's mean
    event and device ms over its two turns, on the real stream and at
    2^20, and every turn's numbers; {} without phase 10."""
    if not turns:
        return {}

    def mean(label, key, i):
        v = [b1[key][i] for lab, _, b1 in turns if lab == label]
        return None if None in v else sum(v) / len(v)
    return {"was_ms": mean("parent", "real", 0),
            "was_ms_N2e20": mean("parent", "N2e20", 0),
            "was_device_ms": mean("parent", "real", 1),
            "was_device_ms_N2e20": mean("parent", "N2e20", 1),
            "in_turns": [(lab, b1) for lab, _, b1 in turns],
            "was_kernel": "the --parent checkout's, timed by kernel_times.py "
                          "--b1 in turns"}


MODEL_KERNELS = ("capitals_vq", "dpv", "qual_tail")


def phase_b2(dev):
    """Phase 11: B2 on the card, held to the same loop over the plain
    versions; then once more under UVC_TPU_TORCH_TRACE_DIR."""
    import torch
    from uvc_tpu_torch import calling, kernels
    from uvc_tpu_torch.kernels import bounds
    from uvc_tpu_torch.kernels.bounds import HBM_BYTES_PER_S
    from uvc_tpu_torch.utils import device_bench, profiling
    n_iter, loops = 10, 3
    kernels.reset_launches()
    r = device_bench.bench_device_model(dev, rows=N_ROWS, n_iter=n_iter,
                                        loops=loops, regime="f32")
    launches = {k: kernels.LAUNCHES[k] for k in MODEL_KERNELS}
    per_loop = {k: v / (loops + 1) for k, v in launches.items()}
    pi, ispec, cfg = device_bench.bench_request(N_ROWS, "f32")
    model = calling.model_backend(dev, "f32").model(cfg, dev)
    lay = model.bind(ispec)
    pi_d = torch.from_numpy(pi).to(dev)
    t0 = time.perf_counter()
    acc_plain = int(device_bench.chain(
        lambda p: model(p, ispec, plain=True)[0], pi_d, n_iter))
    plain_ms = (time.perf_counter() - t0) / n_iter * 1e3
    kb = {k: bounds.bound(k, lay, N_ROWS, "f32") for k in MODEL_KERNELS}
    add_bytes = 2 * pi.nbytes
    bound_ms = (sum(b["bound_ms"] for b in kb.values())
                + add_bytes / HBM_BYTES_PER_S * 1e3)
    print(f"phase 11 B2: {N_ROWS} rows f32, {n_iter} chained evaluations, "
          f"best of {loops}: {r.seconds_per_eval * 1e3:.4f} ms an evaluation,"
          f" {r.rows_per_s:.1f} rows/s; the perturbing add alone "
          f"{r.add_seconds * 1e3:.4f} ms ({add_bytes / 1e6:.1f} MB), the "
          f"model without it {r.model_rows_per_s:.1f} rows/s; bound "
          f"{bound_ms:.4f} ms (K1+K2+K3 "
          f"{sum(b['bound_ms'] for b in kb.values()):.4f} + the add "
          f"{add_bytes / HBM_BYTES_PER_S * 1e3:.4f}); launches {launches} "
          f"in {loops + 1} loops (warm-up included); accumulator {r.acc}, "
          f"plain {acc_plain} (the plain loop {plain_ms:.4f} ms an "
          f"evaluation, one loop)")
    if r.acc != acc_plain:
        raise AssertionError(f"B2 accumulator {r.acc} != plain {acc_plain}")
    if any(v != n_iter for v in per_loop.values()):
        raise AssertionError(f"B2 launches {launches}: not {n_iter} of each "
                             f"kernel a loop")
    with tempfile.TemporaryDirectory(prefix="uvc_b2_trace_") as td:
        os.environ[profiling.ENV_VAR] = td
        try:
            device_bench.bench_device_model(dev, rows=N_ROWS, n_iter=n_iter,
                                            loops=1, regime="f32")
        finally:
            del os.environ[profiling.ENV_VAR]
        traces = [f for f in os.listdir(td) if f.endswith(".json")]
        size = sum(os.path.getsize(os.path.join(td, f)) for f in traces)
    print(f"phase 11 B2 under {profiling.ENV_VAR}: {len(traces)} trace "
          f"files, {size} bytes")
    if not traces:
        raise AssertionError("B2 under the trace variable wrote no trace")
    return dict(rows=N_ROWS, n_iter=n_iter, loops=loops,
                ms_per_eval=r.seconds_per_eval * 1e3, plain_ms=plain_ms,
                rows_per_s=r.rows_per_s, add_ms=r.add_seconds * 1e3,
                model_rows_per_s=r.model_rows_per_s, bound_ms=bound_ms,
                bound_by="bytes" if all(b["bound_by"] == "bytes"
                                        for b in kb.values()) else "mixed",
                kernel_bound_ms={k: b["bound_ms"] for k, b in kb.items()},
                add_bound_ms=add_bytes / HBM_BYTES_PER_S * 1e3,
                launches_per_loop=per_loop, acc=r.acc, acc_plain=acc_plain,
                trace_files=len(traces))


def phase_dryrun(dev):
    """Phase 12: entry on the card against plain, then the dry run over
    4 slots of the card (and over every card, where there are more)."""
    import torch
    from uvc_tpu_torch import kernels
    from uvc_tpu_torch.kernels import bounds
    from uvc_tpu_torch.parallel import dryrun
    fn, args = dryrun.entry(dev)
    got, want = fn(*args), fn(*args, plain=True)
    torch.cuda.synchronize()
    errs, mad = [], 0.0
    for name, g, w in zip(dryrun.ENTRY_OUTPUTS, got, want):
        d = (g.double() - w.double()).abs()
        mad = max(mad, float(d.max()))
        if g.is_floating_point():
            n = int((~torch.isclose(g, w, rtol=1e-5, atol=0)).sum())
        else:
            n = int((d > 1).sum())
        if n:
            errs.append(f"entry {name}: {n} entries beyond phase 3's f32 bar")
    rows = args[0].shape[0]
    ms = cuda_ms(lambda: fn(*args), 20)
    plain_ms = cuda_ms(lambda: fn(*args, plain=True), 3)
    bound_ms = sum(bounds.bound(k, fn.layout, rows, "f32")["bound_ms"]
                   for k in MODEL_KERNELS)
    print(f"phase 12 entry: {[tuple(g.shape) for g in got]} on {dev}, max "
          f"|diff| against plain {mad}; {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"bound {bound_ms:.4f}) for {rows} rows")
    if errs:
        raise AssertionError("\n".join(errs))
    runs = [[dev] * 4]
    if torch.cuda.device_count() > 1:
        runs.append([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    out = []
    for devs in runs:
        t0 = time.time()
        kernels.reset_launches()
        counts = dryrun.dryrun_multidevice(devs, scale=1.0)
        counts["launches"] = {k: kernels.LAUNCHES[k] for k in MODEL_KERNELS}
        counts["seconds"] = time.time() - t0
        counts["slots"] = [str(d) for d in devs]
        print(f"phase 12 dry run over {counts['slots']}: "
              f"{counts['seconds']:.1f} s, launches {counts['launches']}")
        out.append(counts)
    return dict(entry_max_abs_err=mad, entry_rows=rows, entry_ms=ms,
                entry_plain_ms=plain_ms, entry_bound_ms=bound_ms, runs=out)


def trace_idle_share(path, label):
    """(kernel-union ms, traced wall ms, kernel records as (name, ms from
    the span's start) in time order) of a Chrome trace exported by
    torch.profiler: the CUDA kernels that start inside the ``label`` span,
    the union of their intervals, and that span's length; records before
    the span have negative times and count in no union."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    span = max((e for e in events if e.get("name") == label
                and e.get("ph") == "X" and e.get("cat") == "user_annotation"),
               key=lambda e: e["dur"], default=None)
    if span is None:
        return 0.0, None, []
    kern = sorted((e for e in events if e.get("cat") == "kernel"
                   and e.get("ph") == "X"), key=lambda e: e["ts"])
    names = [(e["name"], (e["ts"] - span["ts"]) / 1e3) for e in kern]
    ivs = [(e["ts"], e["ts"] + e["dur"]) for e in kern
           if span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    busy, end = 0.0, None
    for a, b in ivs:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, span["dur"] / 1e3, names


def phase_idle(d, tries=3):
    """Phase 13: the device's idle share on the main path, from an
    untimed run of phase 5's command under maybe_trace, in a span of its
    own (``main_path``).  Before that span, inside the same trace, K1-K3
    run once on a 128-row request: the trace has lost the first two of
    the kernel library's records, and the warm-up shows whether they are
    the first of the trace or the main path's.  A trace that lost main
    path records (fewer than the counters counted) is taken again, up to
    ``tries`` runs; after that the share is not measured (None)."""
    import torch
    from torch.profiler import record_function
    from uvc_tpu_torch import calling, kernels
    from uvc_tpu_torch.utils import device_bench, profiling
    fa, bam = os.path.join(d, "bench.fa"), os.path.join(d, "bench.bam")
    nt = len(os.sched_getaffinity(0))
    label = "main_path"
    pi, ispec, cfg = device_bench.bench_request(MAIN_ROWS, "f32")
    model = calling.model_backend(torch.device("cuda", 0), "f32").model(cfg)
    pi = torch.from_numpy(pi).cuda()
    for attempt in range(1, tries + 1):
        with tempfile.TemporaryDirectory(prefix="uvc_idle_trace_") as td:
            os.environ[profiling.ENV_VAR] = td
            try:
                with profiling.maybe_trace("phase_13"):
                    model(pi, ispec)
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    with record_function(label):
                        run_cli(["-f", fa, "-t", str(nt), bam, "-o",
                                 os.path.join(d, "bench.traced.vcf.gz"),
                                 "--device", "cuda", "--model-regime",
                                 "f32"])
            finally:
                del os.environ[profiling.ENV_VAR]
            launched = sum(kernels.LAUNCHES[k] for k in MODEL_KERNELS)
            path, = [os.path.join(td, f) for f in os.listdir(td)]
            busy, wall, names = trace_idle_share(path, label)
        recs = [(next(k for k in MODEL_KERNELS if f"{k}_kernel" in n), t)
                for n, t in names
                if any(f"{k}_kernel" in n for k in MODEL_KERNELS)]
        warm = sum(t < 0 for _, t in recs)
        kept = len(recs) - warm
        res = dict(kernel_records=kept, launches=launched,
                   warmup_records=warm, warmup_launches=len(MODEL_KERNELS),
                   other_kernel_records=len(names) - len(recs),
                   busy_ms=busy, wall_ms=wall, attempts=attempt,
                   idle_share=None)
        # the model records the trace kept, in time order (ms from the
        # main path's start; the warm-up's are negative)
        print(f"phase 13 run {attempt}: the trace kept {warm} of "
              f"{len(MODEL_KERNELS)} warm-up and {kept} of {launched} main "
              f"path model kernel records (wall {wall} ms): "
              + " ".join(f"{k}@{t:.3f}" for k, t in recs))
        if kept >= launched and wall is not None:
            break
    else:
        print(f"phase 13: idle share not measured: every one of {tries} "
              "traces lost kernel records")
        return res
    res["idle_share"] = 1.0 - busy / wall
    print(f"phase 13: main path under torch.profiler: {launched} model "
          f"kernel launches, {len(names)} kernel records in the trace; "
          f"kernels busy {busy:.4f} ms (union of intervals) of a "
          f"{wall:.3f} ms traced wall: idle share {res['idle_share']:.6f}")
    return res


def start_two_process(d):
    """Phase 14, started: phase 5's command as two processes under
    UVC_TPU_COORDINATOR, each at -t = half the cores, their output to
    files under ``d``.  Returns (procs, stderr paths, VCF path, threads)."""
    import socket
    fa, bam = os.path.join(d, "bench.fa"), os.path.join(d, "bench.bam")
    nt = max(len(os.sched_getaffinity(0)) // 2, 1)
    out = os.path.join(d, "bench.two_process.vcf.gz")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for pid in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO,
                   UVC_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   UVC_TPU_NUM_PROCESSES="2", UVC_TPU_PROCESS_ID=str(pid))
        logs.append(os.path.join(d, f"two_process.{pid}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "uvc_tpu_torch.cli.uvc1", "-f", fa,
                 "-t", str(nt), bam, "-o", out, "--device", "cuda",
                 "--model-regime", "f32"], env=env, cwd=REPO,
                stdout=log, stderr=subprocess.STDOUT))
    return procs, logs, out, nt


def finish_two_process(started, gate_off_body):
    """Phase 14, finished: both processes exit 0, each launched K1 once a
    request, their stripes cover the regions, and the merged body is
    byte-identical to phase 5's."""
    from uvc_tpu_torch import goldens
    procs, logs, out, nt = started
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errs = []
    for p, path in zip(procs, logs):
        with open(path) as fh:
            errs.append(fh.read())
        if p.returncode != 0:
            raise RuntimeError(f"a uvc1 process returned {p.returncode}:\n"
                               f"{errs[-1][-3000:]}")
    shares = []
    for pid, err in enumerate(errs):
        m = re.search(rf"(\d+) regions, (\d+) records in ([\d.]+)s .* model "
                      rf"on (\S+) f32: (\d+) requests.*process {pid} of 2: "
                      rf"(\d+) of the regions.*capitals_vq=(\d+)", err)
        if not m:
            raise AssertionError(f"process {pid}'s summary:\n{err[-2000:]}")
        shares.append(dict(regions=int(m[1]), records=int(m[2]),
                           run_s=float(m[3]), device=m[4],
                           requests=int(m[5]), own_regions=int(m[6]),
                           k1_launches=int(m[7])))
    same = goldens.read_body(out) == gate_off_body
    print(f"phase 14: two processes at -t {nt} each: {shares}; body "
          f"byte-identical to phase 5's: {same}")
    if not same:
        raise AssertionError("the two-process body differs from phase 5's")
    if sum(s["own_regions"] for s in shares) != shares[0]["regions"] or \
            any(s["k1_launches"] != s["requests"] for s in shares):
        raise AssertionError(f"two-process stripes or launches off: {shares}")
    return dict(threads_each=nt, processes=shares)


def phase_record_diff(d):
    """Phase 15: utils/record_diff.py on the card.  Each leg is a fresh
    uvc1 process, so its launch counters start at 0 and its summary line
    reads them at its end: every card leg must have launched K1-K3 once a
    model request, and nothing else."""
    from uvc_tpu_torch.family.device_chain import CHAIN_LAUNCHES
    from uvc_tpu_torch.pileup.device_pass_c import PASS_C_LAUNCHES
    from uvc_tpu_torch.utils import record_diff
    res = record_diff.run("cuda", d)
    bodies = res["bodies"]
    n_lines = sum(a != b for a, b in zip(bodies["device"], bodies["golden"]))
    walls = " ".join(f"{k} {v:.3f} s" for k, v in res["walls"].items())
    print(f"phase 15 record diff: {res['records']} records; the cuda f32 body "
          f"differs from the cpu f64 body on {n_lines} lines, "
          f"{len(res['divergences'])} divergences; the cuda f64 body "
          f"byte-identical: {not res['f64_divergences']}; walls {walls} "
          f"(side by side, beside phases 12 and 14); requests {res['requests']}, devices "
          f"{res['devices']}, launches {res['launches']}")
    errs = list(res["divergences"]) + [f"cuda f64: {e}"
                                       for e in res["f64_divergences"]]
    if res["records"] < 4:
        errs.append(f"{res['records']} records")
    for leg in ("device", "device_f64"):
        n, got = res["requests"][leg], res["launches"][leg]
        chains = got.get("frag_merge", 0) // CHAIN_LAUNCHES["frag_merge"]
        if (n < 1 or not res["devices"][leg].startswith("cuda")
                or any(got[k] != (n if k in MODEL_KERNELS else
                                  CHAIN_LAUNCHES[k] * chains
                                  if k in CHAIN_LAUNCHES else
                                  PASS_C_LAUNCHES[k] * chains
                                  if k in PASS_C_LAUNCHES else 0)
                       for k in got)):
            errs.append(f"{leg} leg on {res['devices'][leg]}: launches {got} "
                        f"over {n} requests")
    if errs:
        raise AssertionError("record diff:\n" + "\n".join(errs[:40]))
    return dict(records=res["records"], lines_f32_vs_f64=n_lines,
                divergences=0, f64_identical=True, walls_s=res["walls"],
                requests=res["requests"], launches=res["launches"])


def kernel_rows(kres, rres, launches, tn_launches, b1, b1_launches,
                b1_calls, turns):
    """The per-kernel results line: one row per kernel (and per mode of
    K2 and K3), with the contract's keys first."""
    csrc = "uvc_tpu_torch/kernels/csrc"

    def timing(r):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
        return {k: r[k] for k in keys if r.get(k) is not None}

    def model_row(name, replaces, by_shape, launched, main_path):
        """A model kernel's row: the main path's shape (f32, 128 rows)
        first, the other shapes beside it."""
        main = by_shape[("f32", MAIN_ROWS)]
        return {"name": name, "route": "cuda", "source": f"{csrc}/"
                f"{name.replace('_rescued', '')}.cu", "replaces": replaces,
                "launches": launched,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in by_shape.values()),
                **timing(main), "library_ms": None, "rows": MAIN_ROWS,
                **{f"{reg}_{n}": timing(r)
                   for (reg, n), r in by_shape.items()
                   if (reg, n) != ("f32", MAIN_ROWS)},
                "main_path": main_path}

    rows = []
    for name, replaces in (("capitals_vq", "uvc_tpu/calling.py:336"),
                           ("dpv", "uvc_tpu/model/dpv.py:128"),
                           ("qual_tail", "uvc_tpu/model/qual.py:69")):
        r = kres[name]
        rows.append(model_row(name, replaces, {
            (reg, n): r[reg if n == N_ROWS else f"{reg} {n}"]
            for reg in ("f32", "f64") for n in (MAIN_ROWS, N_ROWS)},
            launches[name], "phase 5"))
        rows[-1]["status"] = "redesigned: one lane per (row, symbol)"
    k1 = rows[0]
    k1["normal_run"] = {
        f"{mode}_{reg}_{n}": timing(rres[("capitals_vq", reg, mode, n)])
        for mode in ("rescued", "normal") for reg in ("f32", "f64")
        for n in (MAIN_ROWS, N_ROWS)}
    k1["max_abs_err"] = max(k1["max_abs_err"], *(
        v["max_abs_err"] for k, v in rres.items() if k[0] == "capitals_vq"))
    k1["was"], k1["in_turns"] = k1_was(turns)
    k1["was_kernel"] = ("the --parent checkout's, timed by kernel_times.py "
                        "in turns" if turns else
                        "not timed in this run (no --parent)")
    for name, replaces in (("dpv", "uvc_tpu/model/dpv.py:128"),
                           ("qual_tail", "uvc_tpu/model/qual.py:69")):
        row = model_row(f"{name}_rescued", replaces, {
            (reg, n): rres[(name, reg, "rescued", n)]
            for reg in ("f32", "f64") for n in (MAIN_ROWS, N_ROWS)},
            tn_launches[f"{name}_rescued"], "phase 8")
        row["normal_mode"] = {
            f"{reg}_{n}": timing(rres[(name, reg, "normal", n)])
            for reg in ("f32", "f64") for n in (MAIN_ROWS, N_ROWS)}
        row["max_abs_err"] = max(
            row["max_abs_err"], *(v["max_abs_err"] for k, v in rres.items()
                                  if k[0] == name))
        rows.append(row)
    real = next(v for k, v in b1.items() if k[0] == "real")
    rand = b1[("random", "max", True)]
    wide = b1[("wide", "sum", True)]
    real_bound, rand_bound = (b1_bounds_of(r) for r in (real, rand))
    for name, fam in (("dc_sort", "sort"), ("dc_segments", "seg")):
        row = {
            "name": name, "route": "cuda",
            "source": f"{csrc}/device_consensus.cu",
            "replaces": "uvc_tpu/ops/device_consensus.py:58",
            "launches": b1_launches[name],
            "max_abs_err": float(max(v["n_diff"] for v in b1.values())),
            "ms": real[f"{fam}_ms"], "plain_ms": real[f"{fam}_plain_ms"],
            "bound_ms": real_bound[name][0], "bound_by": real_bound[name][1],
            "library_ms": real["lib_ms"] if name == "dc_sort" else None,
            "rows": real["N"], "bound_ms_N2e20": rand_bound[name][0],
            "ms_N2e20": rand[f"{fam}_ms"],
            "plain_ms_N2e20": rand[f"{fam}_plain_ms"],
            "ms_wide_N2e20": wide[f"{fam}_ms"],
            "plain_ms_wide_N2e20": wide[f"{fam}_plain_ms"],
            "main_path": "phase 9", "consensus_calls": b1_calls}
        if name == "dc_sort":
            row.update(library_ms_N2e20=rand["lib_ms"],
                       library_ms_wide_N2e20=wide["lib_ms"],
                       library_route="library_sort: stable torch.sort of "
                       "each packed 64-bit key word, then one gather",
                       plans=[str(p) for p in real["plans"]])
        else:
            row.update(device_ms=real["seg_device_ms"],
                       device_ms_N2e20=rand["seg_device_ms"],
                       device_ms_wide_N2e20=wide["seg_device_ms"],
                       repeats={"real": real["repeat_diff"],
                                "N2e20": rand["repeat_diff"]},
                       status="redesigned: one pass per stage, decoupled "
                       "look-back", library_reason="none: a cumsum, 3-5 "
                       "scatter_reduce calls and gathers a stage",
                       **seg_was(turns))
        rows.append(row)
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose K1-K3 and dc_segments phase 10 "
                    "times in turns")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA GPU")
    print(card_line())
    sys.meta_path.insert(0, _BlockReference())
    sys.path.insert(0, REPO)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from uvc_tpu_torch.kernels import build
    t0 = time.time()
    build.load()
    print(f"phase 2: kernels built and loaded in {time.time() - t0:.1f} s "
          f"({build.BUILD_INFO['path']})")
    ptxas = ptxas_table(build.BUILD_INFO.get("ptxas", ""))
    for e in ptxas:
        print(f"  ptxas {e['name']}: {e.get('registers')} registers, stack "
              f"{e.get('stack')} B, spill stores {e.get('spill_stores')} B, "
              f"spill loads {e.get('spill_loads')} B")

    t0 = time.time()
    kres = phase_kernels(dev)
    print(f"phase 3: done in {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="uvc_chip_smoke_") as d:
        t0 = time.time()
        phase_goldens(d)
        print(f"phase 4: goldens done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches, stats, wall, walls = phase_main_path(d)
        print(f"phase 5: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        chain = phase_family_chain(d)
        print(f"phase 16: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        pass_c = phase_pass_c(d)
        print(f"phase 17: done in {time.time() - t0:.1f} s")
        from uvc_tpu_torch import goldens
        gate_off_body = goldens.read_body(os.path.join(d, "bench.cuda.vcf.gz"))
        t0 = time.time()
        rres = phase_rescued_kernels(dev)
        print(f"phase 6: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_golden_tn(d)
        print(f"phase 7: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        tn_launches, tn_stats, tn_wall, tn_walls, tn_reads = \
            phase_tn_main_path(d)
        print(f"phase 8: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        b1, b1_launches, b1_calls, b1_wall, b1_call, stream = phase_b1(
            dev, d, gate_off_body, wall)
        print(f"phase 9: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        b2 = phase_b2(dev)
        print(f"phase 11: done in {time.time() - t0:.1f} s")
        # phase 14's two processes and phase 15's three start up and run
        # beside phase 12's host-bound dry run; all end before phase 13
        # traces the card
        t0 = time.time()
        started = start_two_process(d)
        with ThreadPoolExecutor(1) as pool:
            rdiff = pool.submit(phase_record_diff, d)
            dry = phase_dryrun(dev)
            print(f"phase 12: done in {time.time() - t0:.1f} s")
            t0 = time.time()
            two = finish_two_process(started, gate_off_body)
            print(f"phase 14: done {time.time() - t0:.1f} s after phase 12")
            rdiff = rdiff.result()
        t0 = time.time()
        idle = phase_idle(d)
        print(f"phase 13: done in {time.time() - t0:.1f} s")
        turns = []
        if args.parent:
            t0 = time.time()
            turns = phase_parent(os.path.abspath(args.parent), stream)
            print(f"phase 10: done in {time.time() - t0:.1f} s")
    if any(m.split(".")[0] in BLOCKED for m in sys.modules):
        raise AssertionError("jax or uvc_tpu was imported")

    rows = kernel_rows(kres, rres, launches, tn_launches, b1,
                       b1_launches, b1_calls, turns)
    print(card_line())
    print(json.dumps({"kernels": rows,
                      "main_path": {"reads": stats["reads"],
                                    "wall_s": wall, "walls_s": walls,
                                    "reads_per_s": stats["reads"] / wall,
                                    "model_cpu_s": stats["model"],
                                    "requests": stats["requests"]},
                      "tn_main_path": {"reads": tn_reads, "wall_s": tn_wall,
                                       "walls_s": tn_walls,
                                       "reads_per_s": tn_reads / tn_wall},
                      "device_prepare": {"wall_s": b1_wall,
                                         "calls": b1_calls, **b1_call},
                      "family_chain": chain, "pass_c": pass_c,
                      "b2": b2, "dryrun": dry, "idle_share": idle,
                      "two_process": two, "record_diff": rdiff,
                      "ptxas": ptxas}))
    assert all(math.isfinite(r["ms"]) for r in rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
