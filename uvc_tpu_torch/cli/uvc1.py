"""uvc1-compatible command-line interface of the PyTorch/CUDA port:
BAM -> bgzipped VCF, tumor-only or the normal run of a tumor-normal pair
(--tumor-vcf; cli/uvctn.py drives both runs).

Parsing, platform inference, scheduling, the worker thread pool and the
ordered bgzf output are uvc_tpu/cli/uvc1.py's.  The quality model runs
in this process through backend.TorchModelBackend: on the GPU by default
(``--device cuda``, the three CUDA kernels, ``--model-regime f32``), or
on the CPU with the kernels' plain PyTorch versions (``--device cpu``,
``--model-regime f64``, the golden regime); the regime follows the
device unless it is given.  With several cards, each request's rows are
split over all of them (backend.TorchModelBackend).
UVC_TPU_DEVICE_PREPARE=1 runs the fragment consensus on the same device
(ops/device_consensus.py).  UVC_TPU_COORDINATOR (with
UVC_TPU_NUM_PROCESSES and UVC_TPU_PROCESS_ID) runs one process of a
multi-process run over torch.distributed (parallel/distributed.py): each
process calls a read-balanced stripe of every window's regions on its
own card and process 0 writes the gathered VCF.

    python -m uvc_tpu_torch.cli.uvc1 --device cuda -f ref.fa -o out.vcf.gz in.bam
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from ..config import UVCConfig, is_provided
from ..constants import SequencingPlatform, CHAR_TO_SYMBOL
from ..io.fasta import FastaFile
from ..schedule import regions as regions_mod
from ..vcfout import aux_records
from ..vcfout import writer as vcf_writer
from .. import calling, kernels
from ..backend import TorchModelBackend
from ..model.params import default_regime
from ..family import device_chain
from ..ops import device_consensus as devcons
from ..utils import logging as ulog
from ..utils import profiling


def build_parser():
    ap = argparse.ArgumentParser(
        prog="uvc_tpu_torch", description="PyTorch/CUDA somatic variant "
        "caller (uvc1-compatible interface)")
    ap.add_argument("bam", help="Input coordinate-sorted BAM file")
    ap.add_argument("-f", "--fasta", dest="fasta_ref_fname",
                    help="Reference FASTA")
    ap.add_argument("-o", "--output", dest="vcf_out_pass_fname", default="-",
                    help="Output bgzipped VCF (- for stdout)")
    ap.add_argument("-s", "--sample", dest="sample_name", default="-")
    ap.add_argument("-t", "--threads", dest="max_cpu_num", type=int, default=8)
    ap.add_argument("-q", "--vqual", dest="vqual", type=float, default=15.0)
    ap.add_argument("-R", "--regions-file", dest="bed_region_fname",
                    default=".")
    ap.add_argument("--targets", dest="tier1_target_region", default=".")
    ap.add_argument("--tumor-vcf", dest="vcf_tumor_fname", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the quality model runs (cuda: the CUDA "
                    "kernels; cpu: their plain PyTorch versions)")
    ap.add_argument("--model-regime", choices=("f32", "f64"), default=None,
                    help="model number regime: f32 = int32/float32 wire "
                    "(accelerator), f64 = int64/float64 (golden); default "
                    "f64 with --device cpu, f32 with --device cuda")
    cfg_fields = {f.name: f for f in dataclasses.fields(UVCConfig)}
    covered = {"bam_input_fname", "fasta_ref_fname", "vcf_out_pass_fname",
               "sample_name", "max_cpu_num", "vqual", "bed_region_fname",
               "tier1_target_region", "vcf_tumor_fname"}
    for name, f in cfg_fields.items():
        if name in covered or name.startswith("inferred_"):
            continue
        flag = "--" + name.replace("_", "-")
        if f.type in (int, "int") or isinstance(f.default, (bool, int)):
            ap.add_argument(flag, dest=name, type=int, default=None)
        elif isinstance(f.default, float):
            ap.add_argument(flag, dest=name, type=float, default=None)
        else:
            ap.add_argument(flag, dest=name, type=str, default=None)
    return ap


def parse_args(argv=None):
    """The parsed arguments, ``model_regime`` filled in from ``device``
    where it was not given."""
    args = build_parser().parse_args(argv)
    if args.model_regime is None:
        args.model_regime = default_regime(args.device)
    return args


def config_from_args(args) -> UVCConfig:
    cfg = UVCConfig()
    for f in dataclasses.fields(UVCConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            cur = getattr(cfg, f.name)
            if isinstance(cur, bool):
                v = bool(v)
            setattr(cfg, f.name, v)
    cfg.bam_input_fname = args.bam
    return cfg


def infer_platform(batch, cfg):
    """selfUpdateByPlatform data scan (CmdLineArgs.cpp:36-111) over the
    first 5000 records."""
    n = min(batch.n, 5000)
    if n == 0:
        return SequencingPlatform.ILLUMINA, 150, 60
    flags = batch.flag[:n]
    countPE = int(np.sum((flags & 0x1) != 0))
    qlens = [150] + [int(batch.seq_off[i + 1] - batch.seq_off[i])
                     for i in range(n)]
    qlens.sort()
    maxMQ = int(batch.mapq[:n].max())
    quals = batch.qual[:batch.seq_off[n]]
    q30_fail = int(np.sum(quals < 30))
    q30_pass = int(np.sum(quals >= 30))
    q20_fail = int(np.sum(quals < 20))
    isPE = countPE > 0
    is2x = 2 * (q30_fail - q20_fail) < q30_pass
    is4x = 4 * (q30_fail - q20_fail) < q30_pass
    isfixqlen = qlens[len(qlens) // 2] * 100 > qlens[-1] * 95
    plat = (SequencingPlatform.ILLUMINA
            if (isPE or is4x or (is2x and isfixqlen))
            else SequencingPlatform.IONTORRENT)
    return plat, qlens[len(qlens) // 2], maxMQ


def _line_pos(line):
    return int(line.split("\t", 2)[1])


MODEL_BATCH_REGIONS = 8


def _dump_debug_locus(rctx, cfg):
    """--debug-tid/--debug-pos locus tracing (CmdLineArgs.hpp:420-423,
    UVC_IN_DEBUG_MODE prints, e.g. main.hpp:2692-2706): dump every model
    plane at the requested position for all 14 symbols to stderr."""
    import numpy as np
    F = rctx["F"]
    p = cfg.debug_pos - rctx["_plan"].ext_beg
    print(f"DEBUG locus tid={cfg.debug_tid} pos={cfg.debug_pos} "
          f"(region-relative {p})", file=sys.stderr)
    for k in sorted(F):
        v = F[k]
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == F["P"]:
            row = v[p]
            print(f"  {k} = {np.asarray(row).tolist()}", file=sys.stderr)
    for k in ("gapSa", "gapTab", "gapMaj"):
        d = F.get(k) or {}
        hits = {kk: vv for kk, vv in d.items() if kk[0] == p}
        if hits:
            print(f"  {k} = {hits}", file=sys.stderr)


def _process_region_chunk(idxs, ctx):
    """Process a chunk of region plans; the per-column quality model runs
    ONCE over the concatenated chunk (calling.model_stage_batched — exact
    per-region equivalence), amortizing numpy dispatch across regions.
    Returns a list of (n_records, rendered_text), one per plan index, and
    the stages' wall seconds.

    Runs on a worker THREAD (the reference's OpenMP pool analog,
    main.cpp:1478-1539): the prepare stage is dominated by GIL-releasing
    native/numpy kernels, and model evaluations go through the process's
    TorchModelBackend, which serializes the device work, so this process
    NEVER forks."""
    cfg = ctx["cfg"]
    is_normal = ctx["is_normal_run"]
    stage_t = {"prepare": 0.0, "model": 0.0, "emit": 0.0, "columns": 0,
               "families_device": 0, "pass_c_device": 0}
    with profiling.span("chunk", parent=ctx["span"],
                        regions=len(idxs)) as chunk:
        t0 = time.time()
        with profiling.span("prepare"):
            prepared = [_prepare_region(i, ctx) for i in idxs]
        stage_t["prepare"] = time.time() - t0
        for k in ("families_device", "pass_c_device"):
            stage_t[k] = sum(getattr(r["res"], k) for r in prepared)
        t0 = time.time()
        with profiling.span("model"):
            calling.model_stage_batched(prepared, cfg,
                                        is_tumor_only=not is_normal)
        stage_t["model"] = time.time() - t0
        stage_t["columns"] = sum(r["F"]["P"] for r in prepared)
        t0 = time.time()
        with profiling.span("emit"):
            out = _emit_regions(prepared, ctx)
        stage_t["emit"] = time.time() - t0
        chunk.set(reads=sum(r["_sub"].n for r in prepared),
                  columns=stage_t["columns"])
    return out, stage_t


def _prepare_region(i, ctx):
    """The prepare stage of plan ``i``: its reads, reference and rescued
    tumor keys, then calling.prepare_region."""
    batch, header, fa, cfg = ctx["batch"], ctx["header"], ctx["fa"], ctx["cfg"]
    is_normal = ctx["is_normal_run"]
    with profiling.span("prepare.slice"):
        plan = ctx["plans"][i]
        sub = regions_mod.slice_batch(batch, plan)
        # per-fetch template-range + BED_END_TO_END read filters
        # (grouping.cpp:405-411) against the owning bedline's window
        sub = regions_mod.region_read_filter(sub, plan, cfg)
        chrom = header.ref_names[plan.tid]
        refstring = fa.fetch(chrom, plan.ext_beg, plan.ext_end)
        ref_syms = CHAR_TO_SYMBOL[
            np.frombuffer(refstring, dtype=np.uint8) & 0x7F]
        tki_map = None
        tki_aux = None
        if is_normal:
            # per-tid pos-sorted index: O(log n + hits) per region instead
            # of a full scan of the tumor VCF for every region (the
            # reference's rescue reader is likewise region-streamed via
            # bcf_sr_seek, main.cpp:184-398)
            import bisect
            idx = ctx["tki_index"].get(plan.tid)
            tki_map = {}
            tki_aux = {}     # MGVCF/<AIC> symbolic records (VTI 15/16):
            if idx is not None:   # tumor columns for the aux emitters only
                poss, keys = idx
                lo = bisect.bisect_left(poss, plan.ext_beg)
                hi = bisect.bisect_left(poss, plan.ext_end)
                tki_all = ctx["tki_all"]
                for k in keys[lo:hi]:
                    if k[2] <= 13:
                        tki_map[k] = tki_all[k]
                    else:
                        tki_aux[(k[1], k[2])] = tki_all[k]
    rctx = calling.prepare_region(
        sub, ref_syms, plan.ext_beg, cfg,
        is_tumor_only=not is_normal, tki_map=tki_map)
    rctx["_tki_aux"] = tki_aux
    rctx["_plan"] = plan
    rctx["_sub"] = sub
    rctx["_chrom"] = chrom
    rctx["_refstring"] = refstring
    rctx["_idx"] = i
    return rctx


def _emit_regions(prepared, ctx):
    """The emit stage of a chunk: (n_records, rendered_text) a region."""
    cfg = ctx["cfg"]
    is_normal = ctx["is_normal_run"]
    out = []
    with profiling.span("emit.log"):
        for rctx in prepared:
            plan_, i_ = rctx["_plan"], rctx["_idx"]
            if ulog.should_log_region(i_, len(ctx["plans"]),
                                      cfg.always_log):
                ulog.log(ulog.INFO,
                         f"region {i_ + 1}/{len(ctx['plans'])} "
                         f"{rctx['_chrom']}:{plan_.beg + 1}-{plan_.end} "
                         f"n_reads={rctx['_sub'].n} P={rctx['F']['P']}")
            if (cfg.debug_tid >= 0 and cfg.debug_tid == plan_.tid
                    and plan_.ext_beg <= cfg.debug_pos < plan_.ext_end):
                _dump_debug_locus(rctx, cfg)
    for rctx in prepared:
        plan, chrom = rctx["_plan"], rctx["_chrom"]
        refstring, i = rctx["_refstring"], rctx["_idx"]
        res, F = rctx["res"], rctx["F"]
        with profiling.span("emit.records"):
            recs = calling.assemble_records(
                rctx, refstring, plan.ext_beg, chrom, cfg,
                is_tumor_only=not is_normal)
        with profiling.span("emit.aux"):
            if cfg.fam_consensus_out_fastq:
                from ..family import consensus_fastq
                from ..pileup import events as ev_mod
                table = ev_mod.expand(rctx["_sub"])
                payloads = consensus_fastq.generate(
                    res.frag_cons, res.famgrp, rctx["_sub"], table, F["P"],
                    cfg, plan.ext_beg, plan.tid)
                consensus_fastq.write_files(
                    f"{cfg.fam_consensus_out_fastq}.region"
                    f"{ctx.get('region_base', 0) + i}", payloads)
            rbeg = plan.beg - plan.ext_beg
            rend = min(plan.end - plan.ext_beg, F["P"])
            lines = []
            # the aux emitters run in NORMAL mode too (the reference's
            # per-position loop emits MGVCF / <ADDITIONAL_INDEL_CANDIDATE>
            # regardless of --tumor-vcf, main.cpp:655-799), with the
            # tumor's retrieved column re-emitted next to each line when
            # is_tumor_format_retrieved (main.cpp:739-755, 784-797)
            tumor_col = None
            if is_normal and cfg.is_tumor_format_retrieved:
                aux_map = rctx["_tki_aux"] or {}

                def tumor_col(p_abs, symbol, _m=aux_map):
                    return aux_records.tumor_aux_column(_m, p_abs, symbol)
            t1e = (plan.t1_end - plan.ext_beg if plan.t1_end > 0
                   else F["P"])
            lines += [(_line_pos(l), 0, l) for l in aux_records.emit_mgvcf(
                F, res, cfg, chrom, refstring, plan.ext_beg, rbeg, rend,
                t1_end=t1e, tumor_col=tumor_col)]
            lines += [(_line_pos(l), 1, l) for l in
                      aux_records.emit_indel_candidates(
                          F, res, cfg, chrom, refstring, plan.ext_beg,
                          rbeg, rend, tumor_col=tumor_col)]
            lines += [(_line_pos(l), 2, l) for l in
                      aux_records.emit_germline(
                          F, F["_germ"], F["_cand"], cfg, chrom, refstring,
                          plan.ext_beg, rbeg, rend)]
        with profiling.span("emit.render"):
            kept = [rec for rec in recs
                    if plan.emit_lo <= rec.vcfpos < plan.emit_hi]
            lines += [(rec.vcfpos, 3, vcf_writer.render_record(chrom, rec))
                      for rec in kept]
            lines.sort(key=lambda t: (t[0], t[1]))
            out.append((len(kept), "".join(l + "\n" for _, _, l in lines)))
    return out


def check_file_exist(fname, ftype):
    """CmdLineArgs.cpp:138-145: clean exit on missing inputs."""
    import os
    if not fname or fname == "." or not os.path.isfile(fname):
        print(f"The file {fname!r} of type ({ftype}) does not exist.",
              file=sys.stderr)
        sys.exit(-4 & 0xFF)


def run(argv=None, stats=None):
    """The uvc1 CLI.  ``stats``, when a dict, receives the run's counts
    and stage seconds: ``prepare``, ``model`` and ``emit`` are each
    stage's wall seconds summed over the worker threads (waits for the
    GIL, the model's lock and the cores included); with the span log on
    (utils/profiling.py) also ``spans``, the leg's span log."""
    role = profiling.leg_role()
    with profiling.maybe_trace(f"uvc1.{role}"), \
            profiling.leg(stats) as leg:
        return _run(argv, stats, leg)


def _decoding(windows, leg):
    """``windows`` (a Tier1Stream iterator, run on the prefetch thread)
    with each window's decode in a span of ``leg``."""
    while True:
        with profiling.span("input.decode", parent=leg):
            w = next(windows, None)
        if w is None:
            return
        yield w


def _tumor_index(tki_all):
    """{tid: (sorted positions, keys)} of the tumor VCF's keys."""
    by_tid = {}
    for k in tki_all:
        by_tid.setdefault(k[0], []).append(k)
    index = {}
    for tid, keys in by_tid.items():
        keys.sort(key=lambda k: k[1])
        index[tid] = ([k[1] for k in keys], keys)
    return index


def _run(argv, stats, leg):
    t0 = time.time()
    with profiling.span("leg.open"):
        args = parse_args(argv)
        cfg = config_from_args(args)
        # magic positional sentinels (common.hpp:58-59, main.cpp:1229-1244)
        if cfg.bam_input_fname == "/only-print-vcf-header/":
            cmdline = " ".join(argv if argv is not None else sys.argv[1:])
            sys.stdout.write(vcf_writer.generate_header(
                cmdline, [], cfg.sample_name, cfg=cfg))
            return 0
        if cfg.bam_input_fname == "/only-print-debug-detail/":
            from ..schedule.regions import (NUM_BYTES_PER_REF_POS,
                                            NUM_BYTES_PER_READ)
            print(f"NUM_BYTES_PER_REF_POS = {NUM_BYTES_PER_REF_POS}")
            print(f"NUM_BYTES_PER_READ = {NUM_BYTES_PER_READ}")
            print(f"mem_per_thread_MB = {cfg.mem_per_thread}")
            return 0
        # multi-host mode ALSO streams memory-bounded tier-1 windows: the
        # stream is deterministic, so every process sees identical windows
        # and plan lists, stripes each window's plans by read count, and
        # the shards are gathered PER WINDOW (host 0 appends in window
        # order, so the merged VCF stays position-sorted and resident
        # reads stay bounded on every host; grouping.cpp:157-314 +
        # bin/uvcTN.sh scale-out semantics)
        dist_on = bool(os.environ.get("UVC_TPU_COORDINATOR"))
        device = args.device
        if dist_on:
            from ..parallel import distributed as dist
            dist.initialize_if_requested()
            # each process owns one card and splits no rows
            device = dist.process_device(device)
        backend = TorchModelBackend(device, args.model_regime)
        devcons.DEVICE = backend.device
        device_chain.DEVICE = backend.device
        check_file_exist(cfg.bam_input_fname, "BAM")
        check_file_exist(cfg.fasta_ref_fname, "FASTA")

        fa = FastaFile(cfg.fasta_ref_fname)
        from ..io import native as native_io
        from ..io.bam import filter_batch

        use_stream = native_io.available()

        # --bed-in REPLAYS a saved region schedule: it is an alias of the
        # -R BED (CmdLineArgs.cpp:1028-1029) -- one mechanism, the BED
        # lines ARE the tier-1 regions
        if (is_provided(cfg.bed_in_fname)
                and not is_provided(cfg.bed_region_fname)):
            cfg.bed_region_fname = cfg.bed_in_fname

        # indexed targeted access (-R/--targets + <bam>.bai): seek the BGZF
        # stream via the BAI linear index and decode ONLY the blocks that
        # can overlap the targets (sam_itr_queryi equivalent,
        # main.cpp:29-70), instead of scanning the whole file
        bai_path = cfg.bam_input_fname + ".bai"
        want_targets = (is_provided(cfg.tier1_target_region)
                        or is_provided(cfg.bed_region_fname))
        if want_targets and not os.path.exists(bai_path):
            # interval scheduling needs the whole batch in memory (the
            # reference index-fetches per bedline); without a .bai, decode
            # the file whole instead of streaming
            use_stream = False
        indexed = use_stream and want_targets and os.path.exists(bai_path)
        if indexed:
            from ..io.stream import BamStream
            st0 = BamStream(cfg.bam_input_fname)
            header = st0.header
            st0.close()
        elif use_stream:
            from ..io import stream as stream_mod
            t1_bytes = int(os.environ.get("UVC_TPU_TIER1_BYTES",
                                          stream_mod.DEFAULT_TIER1_BYTES))
            chunk = int(os.environ.get("UVC_TPU_STREAM_CHUNK",
                                       stream_mod.CHUNK_BYTES))
            t1 = stream_mod.Tier1Stream(
                cfg.bam_input_fname, None, cfg.mem_per_thread,
                tier1_bytes=t1_bytes,
                stream=stream_mod.BamStream(cfg.bam_input_fname,
                                            chunk_bytes=chunk),
                row_filter=lambda b: filter_batch(b, cfg),
                nthreads=cfg.max_cpu_num,
                is_fastq_gen=len(cfg.fam_consensus_out_fastq or "") > 0)
            header = t1.header
            windows = stream_mod.prefetch(_decoding(iter(t1), leg))

    with profiling.span("input.window"):
        if indexed:
            from ..io import bai as bai_mod
            from ..io.bam import concat_batches
            from ..constants import MAX_INSERT_SIZE, MAX_STR_N_BASES
            name2tid = header.name2tid()
            ref_lens0 = {i: ln for i, ln in enumerate(header.ref_lens)}
            ivs = []
            if is_provided(cfg.tier1_target_region):
                ivs += regions_mod.parse_target_region(
                    cfg.tier1_target_region, name2tid, ref_lens0)
            elif is_provided(cfg.bed_region_fname):
                check_file_exist(cfg.bed_region_fname, "BED")
                ivs += regions_mod.read_bed_intervals(cfg.bed_region_fname,
                                                      name2tid)
            linear = bai_mod.read_bai(bai_path)
            halo = MAX_INSERT_SIZE + MAX_STR_N_BASES
            pieces, seen = [], set()
            for (tid, beg, end) in sorted(iv[:3] for iv in ivs):
                b = bai_mod.fetch_interval(cfg.bam_input_fname, linear,
                                           tid, beg, end, halo=halo)
                if b.n:
                    # drop duplicates when target intervals overlap
                    keys = list(zip(b.tid.tolist(), b.pos.tolist(),
                                    b.qnames(), b.flag.tolist()))
                    keep = [i for i, k in enumerate(keys) if k not in seen]
                    seen.update(keys)
                    if len(keep) < b.n:
                        from ..io.bam import subset_batch
                        b = subset_batch(b, np.asarray(keep,
                                                       dtype=np.int64))
                    pieces.append(b)
            batch = (concat_batches(pieces) if pieces
                     else bai_mod._empty_batch())
            batch = filter_batch(batch, cfg)
            use_stream = False
            first_batch = batch
        elif use_stream:
            first_window = next(windows, None)
            first_batch = first_window[0] if first_window else None
        else:
            header, batch = native_io.read_bam_native(cfg.bam_input_fname)
            batch = filter_batch(batch, cfg)
            first_batch = batch

    if cfg.sequencing_platform in (SequencingPlatform.AUTO,
                                   SequencingPlatform.OTHER) \
            and first_batch is not None and first_batch.n:
        plat, central, maxMQ = infer_platform(first_batch, cfg)
    else:
        plat = (cfg.sequencing_platform
                if cfg.sequencing_platform != SequencingPlatform.AUTO
                else SequencingPlatform.ILLUMINA)
        central, maxMQ = cfg.central_readlen or 150, 60
    cfg.self_update_by_platform(plat, central, maxMQ)

    ref_lens = {i: ln for i, ln in enumerate(header.ref_lens)}
    with profiling.span("input.plan"):
        # user target scheduling (-R BED / --targets chrom:beg-end;
        # grouping.cpp:69-157): the intervals ARE the tier-1 regions
        # (SamIter bedlines mode) -- no gap or memory cuts inside one
        sched_ivs = None
        if is_provided(cfg.tier1_target_region):
            sched_ivs = regions_mod.parse_target_region(
                cfg.tier1_target_region, header.name2tid(), ref_lens)
        elif is_provided(cfg.bed_region_fname):
            check_file_exist(cfg.bed_region_fname, "BED")
            sched_ivs = regions_mod.read_bed_intervals(
                cfg.bed_region_fname, header.name2tid())

        if use_stream:
            def _window_iter():
                if first_window is not None:
                    yield first_window
                    while True:
                        with profiling.span("input.window"):
                            w = next(windows, None)
                        if w is None:
                            return
                        yield w
            window_iter = _window_iter()
            plans = None
        elif sched_ivs is not None:
            plans = regions_mod.plan_intervals(sched_ivs, batch, ref_lens)
        else:
            plans = regions_mod.plan(
                batch, ref_lens, cfg.mem_per_thread,
                nthreads=cfg.max_cpu_num,
                is_fastq_gen=len(cfg.fam_consensus_out_fastq or "") > 0)

    is_normal_run = is_provided(cfg.vcf_tumor_fname)
    tki_all, tki_index = None, {}
    if is_normal_run:
        with profiling.span("leg.tumor_vcf"):
            from ..vcfout import reader as vcf_reader
            tki_all = vcf_reader.read_tumor_vcf(cfg.vcf_tumor_fname,
                                                header.name2tid())
            tki_index = _tumor_index(tki_all)

    cmdline = " ".join(argv if argv is not None else sys.argv[1:])
    header_text = vcf_writer.generate_header(
        cmdline, list(zip(header.ref_names, header.ref_lens)),
        cfg.sample_name, cfg=cfg,
        tumor_sample="TUMOR" if is_normal_run else None)
    out = None
    dist_out_fh = None
    with profiling.span("output.write"):
        if not dist_on:
            out = vcf_writer.VcfWriter(cfg.vcf_out_pass_fname)
            out.write(header_text)
        elif dist.rank() == 0:
            from ..io import bgzf as _bgzf
            dist_out_fh = open(cfg.vcf_out_pass_fname, "wb")
            dist_out_fh.write(_bgzf.compress(header_text.encode()))

    # the model runs in this process on the backend's device; the f32
    # regime casts each request to the int32 wire.  A GPU takes one
    # larger request per worker (fewer launches); the CPU keeps finer
    # chunks for pool balance.
    model_on_accel = backend.device.type == "cuda"
    calling._MODEL_CAST_F32 = backend.regime.name == "f32"
    calling._MODEL_EVAL = backend.eval

    bed_out_fh = (open(cfg.bed_out_fname, "w")
                  if is_provided(cfg.bed_out_fname) else None)

    n_records = 0
    n_reads = 0
    total_regions = 0
    own_regions = windows_done = 0    # this process's stripes (dist_on)
    shard_texts = [] if dist_on else None
    stage_totals = {"prepare": 0.0, "model": 0.0, "emit": 0.0, "columns": 0,
                    "families_device": 0, "pass_c_device": 0}
    n_workers_est = min(cfg.max_cpu_num, os.cpu_count() or 1) or 1
    pool = None  # lazily-created worker thread pool, shared across windows

    def _emit(nrec, text):
        nonlocal n_records
        n_records += nrec
        if dist_on:
            shard_texts.append(text)
        else:
            with profiling.span("output.write"):
                out.write(text)

    def _account(stage_t):
        for k in stage_totals:
            stage_totals[k] += stage_t[k]

    def _process_window(wbatch, wplans, region_base):
        """Restrict/split one tier-1 window's plans and run the worker
        pipeline over them; returns the number of tier-2 regions."""
        nonlocal n_reads, pool, own_regions, windows_done
        windows_done += 1
        n_reads += wbatch.n
        with profiling.span("input.plan"):
            if sched_ivs is not None:
                # interval scheduling replaces the SamIter gap/memory cuts
                # entirely (only reachable with the whole batch: streaming
                # is disabled when targets are provided)
                wplans = regions_mod.plan_intervals(sched_ivs, wbatch,
                                                    ref_lens)
            if bed_out_fh:
                for p in wplans:
                    bed_out_fh.write(
                        f"{header.ref_names[p.tid]}\t{p.beg}\t{p.end}\t"
                        f"NumberOfReadsInThisInterval\t"
                        f"{p.read_end - p.read_beg}\t+\n")
            # tier-2 work-unit chunking (main.cpp:1374-1400): split large
            # regions into fixed-size units the pool can balance; unit
            # size does not depend on -t, so output is thread-count
            # invariant
            wplans = regions_mod.split_plans_into_units(wplans, wbatch,
                                                        ref_lens)
        shard_lo, shard_hi = 0, len(wplans)
        if dist_on:
            _, shard_lo, shard_hi = dist.my_plans(wplans)
        n_shard = shard_hi - shard_lo
        own_regions += n_shard
        if n_shard <= 0:
            return len(wplans)
        work_ctx = dict(batch=wbatch, header=header, fa=fa, cfg=cfg,
                        plans=wplans, is_normal_run=is_normal_run,
                        tki_all=tki_all, tki_index=tki_index,
                        region_base=region_base, span=leg)
        n_workers = min(cfg.max_cpu_num, os.cpu_count() or 1, n_shard) \
            if n_shard > 1 else 1
        # chunk plans for the batched model stage: ~4 tasks per worker on
        # CPU, ONE per worker on the GPU (fewer, larger requests)
        if model_on_accel:
            csz = max(1, -(-n_shard // n_workers_est))
        else:
            csz = max(1, min(MODEL_BATCH_REGIONS,
                             -(-n_shard // (n_workers_est * 4))))
        chunks = [list(range(lo, min(lo + csz, shard_hi)))
                  for lo in range(shard_lo, shard_hi, csz)]
        if n_workers > 1:
            # data-parallel region processing in worker THREADS with
            # ordered serial output, mirroring the reference's pool +
            # serial concat (main.cpp:1478-1551).  Prepare time is
            # dominated by GIL-releasing ctypes/numpy kernels; model
            # requests overlap the other threads' prepare because torch
            # releases the GIL while the device works.
            from concurrent.futures import ThreadPoolExecutor
            if pool is None:
                pool = ThreadPoolExecutor(
                    max_workers=n_workers_est,
                    thread_name_prefix="uvc-worker")
            futs = [pool.submit(_process_region_chunk, chunk, work_ctx)
                    for chunk in chunks]
            for f in futs:
                with profiling.span("pool.wait"):
                    results, stage_t = f.result()
                _account(stage_t)
                for nrec, text in results:
                    _emit(nrec, text)
        else:
            for chunk in chunks:
                results, stage_t = _process_region_chunk(chunk, work_ctx)
                _account(stage_t)
                for nrec, text in results:
                    _emit(nrec, text)
        return len(wplans)

    def _flush_window_shard():
        """Collective per-window gather: every process contributes its
        stripe's bgzf blob; host 0 appends in (window, process) order so
        the merged VCF stays position-sorted with bounded resident text."""
        from ..io import bgzf as _bgzf
        with profiling.span("output.write"):
            blob = _bgzf.compress("".join(shard_texts).encode()) \
                if shard_texts else b""
            shard_texts.clear()
            for blk in dist.allgather_bytes(blob):
                if dist_out_fh is not None:
                    dist_out_fh.write(blk)

    try:
        if use_stream:
            for wbatch, wplans in window_iter:
                total_regions += _process_window(wbatch, wplans,
                                                 total_regions)
                if dist_on:
                    _flush_window_shard()
        else:
            total_regions = _process_window(batch, plans, 0)
            if dist_on:
                _flush_window_shard()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    with profiling.span("output.close"):
        if bed_out_fh:
            bed_out_fh.close()
        if dist_on:
            if dist_out_fh is not None:
                from ..io import bgzf as _bgzf
                dist_out_fh.write(_bgzf.BGZF_EOF)
                dist_out_fh.close()
            dist_rank, dist_size = dist.rank(), dist.world_size()
            dist.shutdown()
        else:
            out.close()
        if cfg.fam_consensus_out_fastq:
            # concatenate the per-region gzip members into the final three
            # files (gzip member concatenation is a valid gzip stream), in
            # deterministic region order; mirrors the reference's single
            # R1/R2/SE outputs (main.cpp:1186-1190)
            from ..family.consensus_fastq import SUFFIXES
            pref = cfg.fam_consensus_out_fastq
            for suffix in SUFFIXES:
                with open(f"{pref}.{suffix}", "wb") as dst:
                    for i in range(total_regions):
                        part = f"{pref}.region{i}.{suffix}"
                        if os.path.exists(part):
                            with open(part, "rb") as src:
                                dst.write(src.read())
                            os.remove(part)
    leg.set(reads=n_reads, regions=total_regions, threads=n_workers_est)
    dt = time.time() - t0
    cols = stage_totals["columns"]
    launches = " ".join(f"{k}={v}" for k, v in kernels.LAUNCHES.items())
    devprep = ""
    if os.environ.get("UVC_TPU_DEVICE_PREPARE", "") == "1":
        devprep = (f"; device-prepare on {devcons.DEVICE}: "
                   f"{devcons.STATS['calls']} programs / "
                   f"{devcons.STATS['rows']} event rows")
    if dist_on:
        devprep += (f"; process {dist_rank} of {dist_size}: {own_regions} "
                    f"of the regions in {windows_done} windows")
    stages = ("prepare", "model", "emit")
    cpu = profiling.cpu_seconds(leg, stages)
    cpu_text = ("; thread cpu-s: " + " ".join(
        f"{k}={cpu[k]:.2f}" for k in stages)) if cpu else ""
    native = native_host_libs()
    print(f"uvc_tpu_torch: {n_reads} reads, {total_regions} regions, "
          f"{n_records} records in {dt:.2f}s "
          f"({n_reads / max(dt, 1e-9):.0f} reads/s, "
          f"{cols / max(dt, 1e-9):.0f} columns/s; wall-s summed over "
          f"workers: "
          f"prepare={stage_totals['prepare']:.2f} "
          f"model={stage_totals['model']:.2f} "
          f"emit={stage_totals['emit']:.2f}{cpu_text}; model on "
          f"{backend.device} "
          f"{backend.regime.name}: {backend.requests} requests "
          f"({backend.rescued_requests} rescued), {backend.rows} rows"
          f"{devprep}; family chain on {device_chain.DEVICE} in "
          f"{stage_totals['families_device']} of {total_regions} regions"
          f", pass C in {stage_totals['pass_c_device']}"
          f"; kernel launches: {launches}; native host "
          f"libraries: {' '.join(f'{k}={v}' for k, v in native.items())})",
          file=sys.stderr)
    if stats is not None:
        stats.update(reads=n_reads, regions=total_regions,
                     records=n_records, seconds=dt, **stage_totals,
                     requests=backend.requests,
                     rescued_requests=backend.rescued_requests,
                     rows=backend.rows,
                     native=native)
    return 0


def native_host_libs():
    """Whether the native host libraries (bin/rowpile.so, bin/bamdec.so,
    built from native/ at first use) loaded; without them the host
    prepare runs its slower python paths."""
    from ..io import native as bamdec
    from ..ops import native_rowpile
    return {"rowpile": native_rowpile.available(),
            "bamdec": bamdec.available()}


if __name__ == "__main__":
    sys.exit(run())
