#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uvc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. print the card (nvidia-smi name and power limit); no CUDA -> exit 1;
2. build the three model kernels (kernels/csrc/*.cu) and print the time;
3. on a 65,536-row packed model request of real example planes (a
   4,096-row payload tiled 16 times), hold each kernel against its plain
   PyTorch version on the card, from the same inputs, in both regimes,
   and time both with CUDA events.  Bars: f64 ints equal but for at most
   0.01% of a leaf's entries, each within 1 (the card's exp/log and
   torch's can differ in the last ulp), floats within rtol 1e-12; f32
   ints within 1, floats within rtol 1e-5;
4. run uvc1 --device cuda on the three committed golden workloads: f64
   against the golden bar (same records, FILTERs and QUAL text, FORMAT
   within 1), f32 against the accelerator contract (QUAL within 0.51);
5. the main path: uvc1 --device cuda --model-regime f32 on the 45,000-read
   bench workload (30 kbp, depth 150) at -t = cores, with the kernels'
   launch counters set to 0 just before its three timed runs and read
   just after; every model request must have gone through K1-K3.  Its VCF is held to the f32
   contract against a --device cpu --model-regime f64 run of the same
   input;
6. K2 and K3 in the normal run's two modes, rescued (a seeded quarter of
   the entries carry tumor allele fractions) and normal (none), against
   their plain versions at 65,536 rows in both regimes, under phase 3's
   bars, timed with CUDA events;
7. uvctn --device cuda on golden_tn: f64 against the golden bar, f32
   against the contract, both sample columns;
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
   0 differing entries, both timed, each radix sort's plan printed; then
   the bench workload through uvc1 --device cuda with
   UVC_TPU_DEVICE_PREPARE=1, counters set to 0 just before and read just
   after: each consensus call launches dc_sort and dc_segments twice,
   and the VCF body is
   byte-identical to phase 5's gate-off body.

The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}.  Nothing of JAX is imported: the script
blocks it.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 65536
TILE = 4096


class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name}: the port must not import JAX")
        return None


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


def check_and_time(tag, model, pi, oi, of, kernel, plain, leaves, regime,
                   errs, mode=()):
    """One stage: the plain version into (oi, of), the kernel into copies,
    from the same inputs; every leaf held to phase 3's bars (failures
    appended to ``errs``); then both timed.  ``mode`` is (pf,
    is_tumor_only) for K2/K3 in a normal-run mode."""
    import torch
    lay = model.layout
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
        if lay.out_kind[leaf] == "f":
            errs.append(f"{tag} {leaf}: {nd} float entries beyond rtol "
                        f"{rtol}")
        elif m > 1 or (regime == "f64" and nd > 1e-4 * size):
            errs.append(f"{tag} {leaf}: {nd}/{size} int entries differ, "
                        f"max {m}")
    ms = cuda_ms(lambda: kernel(pi, oi_k, of_k, model, *mode), 20)
    plain_ms = cuda_ms(lambda: plain(pi, oi_k, of_k, model, *mode), 3)
    print(f"{tag}: {len(leaves)} leaves, {n_diff} entries differ, max "
          f"|diff| {mad}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return dict(max_abs_err=mad, n_diff=n_diff, ms=ms, plain_ms=plain_ms)


def phase_kernels(dev):
    """Phase 3: every kernel against its plain version at 65,536 rows."""
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
                f"phase 3 {regime} {name}", model, pi, oi, of, kernel, plain,
                leaves, regime, errs)
        del pi, oi, of
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
    """Phase 4: the CLI on the card against the committed goldens."""
    from uvc_tpu_torch import goldens
    inputs = goldens.build_inputs(d)
    for regime in ("f64", "f32"):
        for name in goldens.NAMES:
            out = os.path.join(d, f"{name}.{regime}.vcf.gz")
            run_cli(inputs[name] + ["--device", "cuda", "--model-regime",
                                    regime, "-o", out])
            same, errs = goldens.compare(goldens.read_body(out),
                                         goldens.golden(name), regime)
            print(f"phase 4 {name} {regime}: {len(errs)} divergences; body "
                  f"byte-identical to the golden: {same}")
            if errs:
                raise AssertionError(f"{name} {regime}:\n"
                                     + "\n".join(errs[:30]))


def phase_main_path(d):
    """Phase 5: the bench workload through uvc1 on the card, f32."""
    from uvc_tpu_torch import goldens, kernels
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
    print(f"phase 5: {stats['reads']} reads at -t {nt}, 3 runs in "
          f"{' '.join(f'{w:.3f}' for w in walls)} s; best "
          f"{stats['reads'] / wall:.1f} reads/s; {stats['records']} records;"
          f" cpu-s prepare={stats['prepare']:.3f} model={stats['model']:.3f} "
          f"emit={stats['emit']:.3f}; {stats['requests']} model requests of "
          f"{stats['rows']} rows in all per run; launches {launches} over "
          f"{requests} requests; native host libraries {stats['native']}")
    if (requests < 1
            or any(launches[k] != requests
                   for k in ("capitals_vq", "dpv", "qual_tail"))
            or any(v for k, v in launches.items()
                   if k not in ("capitals_vq", "dpv", "qual_tail"))):
        raise AssertionError(f"launches {launches} != {requests} model "
                             "requests: the main path skipped a kernel")
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


def phase_rescued_kernels(dev):
    """Phase 6: K2/K3 in the normal run's modes against plain, 65,536 rows."""
    import numpy as np
    import torch
    from uvc_tpu_torch.backend import TorchModelBackend
    from uvc_tpu_torch.kernels import capitals_vq, dpv, qual_tail
    from uvc_tpu_torch.kernels.layout import K2_LEAVES, K3_LEAVES
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
            capitals_vq.capitals_vq(pi, oi, of, model)
            for name, kernel, plain, leaves in stages:
                res[(name, regime, mode)] = check_and_time(
                    f"phase 6 {regime} {mode} {name}", model, pi, oi, of,
                    kernel, plain, leaves, regime, errs, (pf, False))
            del pi, pf, oi, of
            torch.cuda.empty_cache()
    if errs:
        raise AssertionError("rescued-mode kernels disagree with their plain "
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
          f"({stats['normal']['rescued_requests']} rescued), cpu-s prepare="
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


def b1_compare(dev, cols, mode, ovr, reps):
    """dc_sort and dc_segments against their plain versions on the card
    from the stage-1 table of ``cols``: (differing entries, kernel ms and
    plain ms per family, N, the kernel's two sort plans)."""
    import torch
    from uvc_tpu_torch.ops import device_consensus as tdc
    table = torch.from_numpy(tdc.stage1_table(*cols)).to(dev)
    N = table.shape[1]
    kw = dict(dtype=torch.int32, device=dev)
    mode_sum = mode == "sum"
    runs = {}
    for impl in ("kernel", "plain"):
        sort = tdc.dc_sort if impl == "kernel" else tdc.dc_sort_plain
        seg = tdc.dc_segments if impl == "kernel" else tdc.dc_segments_plain
        buf1 = table.clone()
        out_u, out_c = torch.zeros((4, N), **kw), torch.zeros((6, N), **kw)
        buf2, counts = torch.empty((9, N), **kw), torch.zeros(2, **kw)
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
        ms_seg = cuda_ms(lambda: (
            seg(1, s1, mode_sum, ovr, out_u, buf2, counts),
            seg(2, s2, mode_sum, ovr, out_c, None, counts)), n)
        runs[impl] = ([s1, t2, s2, out_u, out_c, counts],
                      max(ms_sort - ms_copy, 0.0), ms_seg, plans)
    n_diff = sum(int((a != b).sum()) for a, b in zip(runs["kernel"][0],
                                                     runs["plain"][0]))
    return (n_diff, runs["kernel"][1], runs["kernel"][2], runs["plain"][1],
            runs["plain"][2], N, runs["kernel"][3])


def print_b1(tag, r):
    print(f"{tag}: {r[0]} entries differ; dc_sort x2 {r[1]:.4f} ms (plain "
          f"{r[3]:.4f}), dc_segments x2 {r[2]:.4f} ms (plain {r[4]:.4f})")
    for stage, plan in zip((1, 2), r[6]):
        print(f"  dc_sort stage {stage} plan: {plan}")


def phase_b1(dev, d, gate_off_body, gate_off_wall):
    """Phase 9: B1 kernels against plain, then the gated main path."""
    import numpy as np
    from uvc_tpu_torch import goldens, kernels
    from uvc_tpu_torch.ops import device_consensus as tdc
    res, errs = {}, []
    rng = np.random.default_rng(9)
    n = (1 << 20) - 4096
    cols = (rng.integers(0, n // 2, n), rng.integers(0, 30000, n),
            rng.integers(0, 14, n), rng.integers(0, 60, n))
    for mode in ("max", "sum"):
        for ovr in (False, True):
            r = b1_compare(dev, cols, mode, ovr, 5)
            res[("random", mode, ovr)] = r
            print_b1(f"phase 9 random N={r[5]} {mode} ovr={ovr}", r)
            if r[0]:
                errs.append(f"random {mode} ovr={ovr}: {r[0]} entries differ")
    i32 = (-2**31, 2**31)
    wide = (rng.integers(*i32, n), rng.integers(*i32, n),
            rng.integers(0, 14, n), rng.integers(-60, 60, n))
    r = b1_compare(dev, wide, "sum", True, 5)
    res[("wide", "sum", True)] = r
    print_b1(f"phase 9 wide keys N={r[5]} sum ovr=True", r)
    if r[0] or any(len(p.words) < 2 for p in r[6]):
        errs.append(f"wide keys: {r[0]} entries differ, plans "
                    f"{[str(p) for p in r[6]]}")

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
    r = b1_compare(dev, rcols, rmode, rovr, 20)
    res[("real", rmode, rovr)] = r
    print_b1(f"phase 9 real stream of {len(rcols[0])} rows (N={r[5]}, "
             f"{rmode}, ovr={rovr})", r)
    if r[0]:
        errs.append(f"real stream: {r[0]} entries differ")
    # one consensus call's cost on that stream, by part (host clock)
    t0 = time.perf_counter()
    for _ in range(3):
        tdc.stage1_table(*rcols)
    table_ms = (time.perf_counter() - t0) * 1e3 / 3
    t0 = time.perf_counter()
    for _ in range(3):
        tdc.device_reduce_consensus(*rcols, 0, rmode, rovr)
    call_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"phase 9 one consensus call on the real stream: {call_ms:.3f} ms "
          f"in all; host table {table_ms:.3f} ms, kernels "
          f"{r[1] + r[2]:.3f} ms, the rest (copies, allocation, launches, "
          f"slicing) {call_ms - table_ms - r[1] - r[2]:.3f} ms")
    if errs:
        raise AssertionError("B1:\n" + "\n".join(errs))
    return res, launches, calls, wall, dict(call_ms=call_ms,
                                            table_ms=table_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA GPU")
    print(card_line())
    sys.meta_path.insert(0, _BlockJax())
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
    for line in build.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    kres = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="uvc_chip_smoke_") as d:
        t0 = time.time()
        phase_goldens(d)
        print(f"phase 4: goldens done in {time.time() - t0:.1f} s")
        launches, stats, wall, walls = phase_main_path(d)
        from uvc_tpu_torch import goldens
        gate_off_body = goldens.read_body(os.path.join(d, "bench.cuda.vcf.gz"))
        t0 = time.time()
        rres = phase_rescued_kernels(dev)
        print(f"phase 6: done in {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_golden_tn(d)
        print(f"phase 7: done in {time.time() - t0:.1f} s")
        tn_launches, tn_stats, tn_wall, tn_walls, tn_reads = \
            phase_tn_main_path(d)
        t0 = time.time()
        b1, b1_launches, b1_calls, b1_wall, b1_call = phase_b1(
            dev, d, gate_off_body, wall)
        print(f"phase 9: done in {time.time() - t0:.1f} s")
    if any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules):
        raise AssertionError("jax was imported")

    csrc = "uvc_tpu_torch/kernels/csrc"
    rows = []
    for name, replaces in (("capitals_vq", "uvc_tpu/calling.py:336"),
                           ("dpv", "uvc_tpu/model/dpv.py:128"),
                           ("qual_tail", "uvc_tpu/model/qual.py:69")):
        r = kres[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["f32"]["max_abs_err"],
                               r["f64"]["max_abs_err"]),
            "ms": r["f32"]["ms"], "plain_ms": r["f32"]["plain_ms"],
            "ms_f64": r["f64"]["ms"], "plain_ms_f64": r["f64"]["plain_ms"],
            "rows": N_ROWS, "main_path": "phase 5"})
    for name, replaces in (("dpv", "uvc_tpu/model/dpv.py:128"),
                           ("qual_tail", "uvc_tpu/model/qual.py:69")):
        r = {k: rres[(name, reg, "rescued")] for k, reg in
             (("f32", "f32"), ("f64", "f64"))}
        normal = {reg: rres[(name, reg, "normal")] for reg in ("f32", "f64")}
        rows.append({
            "name": f"{name}_rescued", "route": "cuda",
            "source": f"{csrc}/{name}.cu", "replaces": replaces,
            "launches": tn_launches[f"{name}_rescued"],
            "max_abs_err": max(x["max_abs_err"] for x in
                               list(r.values()) + list(normal.values())),
            "ms": r["f32"]["ms"], "plain_ms": r["f32"]["plain_ms"],
            "ms_f64": r["f64"]["ms"], "plain_ms_f64": r["f64"]["plain_ms"],
            "normal_mode_ms": normal["f32"]["ms"],
            "normal_mode_plain_ms": normal["f32"]["plain_ms"],
            "rows": N_ROWS, "main_path": "phase 8"})
    real = next(v for k, v in b1.items() if k[0] == "real")
    rand = b1[("random", "max", True)]
    wide = b1[("wide", "sum", True)]
    for i, name in ((1, "dc_sort"), (2, "dc_segments")):
        row = {
            "name": name, "route": "cuda",
            "source": f"{csrc}/device_consensus.cu",
            "replaces": "uvc_tpu/ops/device_consensus.py:58",
            "launches": b1_launches[name],
            "max_abs_err": float(max(v[0] for v in b1.values())),
            "ms": real[i], "plain_ms": real[i + 2], "rows": real[5],
            "ms_N2e20": rand[i], "plain_ms_N2e20": rand[i + 2],
            "ms_wide_N2e20": wide[i], "plain_ms_wide_N2e20": wide[i + 2],
            "main_path": "phase 9", "consensus_calls": b1_calls}
        if name == "dc_sort":
            row["plans"] = [str(p) for p in real[6]]
        rows.append(row)
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
                                         "calls": b1_calls, **b1_call}}))
    assert all(math.isfinite(r["ms"]) for r in rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
