"""call_region with pass C and the family chain on the card.

The same steps as pileup/region.py's call_region, with pass C and the
family chain routed.  region.py is a copy of the JAX package's, held to it
by tests/test_torch_host.py, and is no longer on the port's path:
calling.py's prepare_region calls this module's call_region.  Where
family/device_chain.route_device gives a device and no family is
duplex-flagged, the fragment merge with pass D, the family merge and both
sweeps run there (family/device_chain.run), and the host runs pass D's
sparse passes and the family engine's tail (device_chain.fq_result) on
their arrays.  Elsewhere, or where the device route returns None, the host
route runs (``_host_chain``: region.py's second ``prepare.families``
block).  Pass C takes the same device (pileup/device_pass_c.route), also
where a family is duplex-flagged; its planes stay on the card for the
chain, which reads its event columns, bg and aDP4 there, and come back
with the chain's readback, or with one of their own
(device_pass_c.result).  tests/test_torch_family_chain.py holds
call_region to region.py's but for the routed pass C statement, the routed
block and the result, and ``_host_chain`` to that block, statement for
statement.  Every ``prepare.families`` span, and the ``prepare.pileup``
span that holds pass C, carries ``route`` (``device`` or ``host``), and
the result's ``families_device`` and ``pass_c_device`` say which route the
chain and pass C took.
"""

from dataclasses import dataclass

import numpy as np

from ..constants import AssayType, SequencingPlatform
from ..family import dedup, device_chain, engine_fq
from ..model import sscs
from ..utils.profiling import span
from . import bqcorr
from . import consensus as cns
from . import device_pass_c, engine_bq, events, strscan
from .region import RegionResult, infer_assay


@dataclass
class DeviceRegionResult(RegionResult):
    families_device: bool = False
    pass_c_device: bool = False


def call_region(batch, ref_syms, region_offset, cfg,
                is_normal=False) -> DeviceRegionResult:
    P = len(ref_syms)
    with span("prepare.pileup"):
        # the read slice shares storage with the whole-BAM batch (and with the
        # pad reads of adjacent work units): correct a private copy so each
        # region sees pristine base qualities, like the reference's per-region
        # BAM fetch (grouping.cpp:608-664) -- never mutate shared memory
        batch.qual = batch.qual.copy()
        bqcorr.apply(batch, cfg)
        table = events.expand(batch)

    platform = cfg.inferred_sequencing_platform
    if platform == SequencingPlatform.AUTO:
        platform = SequencingPlatform.ILLUMINA
    with span("prepare.families") as fam_span:
        famgrp = dedup.group_families(batch, table, cfg, cfg.assay_type, platform)
        assay = infer_assay(famgrp, cfg)

    with span("prepare.pileup") as pile_span:
        tracks = strscan.scan_repeats(
            ref_syms, cfg.indel_str_repeatsize_max, cfg.indel_vntr_repeatsize_max,
            cfg.indel_BQ_max, cfg.indel_polymerase_slip_rate,
            cfg.indel_del_to_ins_err_ratio)
        baq = strscan.baq_offsets(tracks, use_anyTR=False,
                                  indel_str_phred_per_region=cfg.indel_str_phred_per_region,
                                  indel_nonSTR_phred_per_base=cfg.indel_nonSTR_phred_per_base,
                                  indel_polymerase_size=cfg.indel_polymerase_size)
        baq2 = strscan.baq_offsets(tracks, use_anyTR=True,
                                   indel_str_phred_per_region=cfg.indel_str_phred_per_region,
                                   indel_nonSTR_phred_per_base=cfg.indel_nonSTR_phred_per_base,
                                   indel_polymerase_size=cfg.indel_polymerase_size)

        dflag = famgrp.frag_dflag[famgrp.frag_of_read]
        if assay == AssayType.AMPLICON:
            dflag = dflag | 0x4

        prep = engine_bq.pass_a_prep(table, batch, ref_syms, tracks, baq,
                                     region_offset, P, cfg, dflag)
        thres = engine_bq.pass_b_thres(prep, tracks, cfg, is_normal)
        allev, gap_info = engine_bq.compute_event_values(
            table, batch, ref_syms, tracks, baq, baq2, prep, thres,
            region_offset, P, cfg, dflag,
            is_proton=(platform == SequencingPlatform.IONTORRENT))
        pc = device_pass_c.route(
            allev, table, baq, baq2, thres, region_offset, P, cfg, dflag)

    with span("prepare.families") as chain_span:
        device = device_chain.route_device(cfg)
        if np.any((famgrp.fam_dflag & 0x2) != 0) \
                or getattr(allev, "stream_off", None) is None:
            device = None
        out = None
        if device is not None:
            sscs_table = sscs.table_from_cfg(cfg)
            ci = device_chain.chain_input(allev, famgrp, table, pc.info,
                                          pc.bg, ref_syms, sscs_table, cfg)
            out = device_chain.run(ci, device, pass_c=pc.run)
        info, bg, a1, a2 = device_pass_c.result(pc)
        if out is None:
            frag_gc, bq_res, fq_res = _host_chain(
                allev, gap_info, famgrp, table, info, bg, a1, a2, prep,
                thres, baq, baq2, ref_syms, batch, P, cfg, is_normal)
        else:
            frag_gc = None
            bdp, bta, btb, hist, vq_bMQ, frag_indel, mutforms = \
                engine_bq.pass_d_fragments(
                    allev, gap_info, table, ref_syms, famgrp.frag_of_read,
                    famgrp.frag_strand, P, cfg, info, bg, batch=batch,
                    precomputed=out.pass_d)
            bIAQ, bIAD, bIDQ = engine_bq.final_iid_qualities(bdp, bg, info,
                                                             hist, P)
            bq_res = engine_bq.BQResult(
                prep=prep, thres=thres, seginfo=info, bg_bqsum=bg,
                vq_a1BQ=a1, vq_a2BQ=a2, vq_bMQ=vq_bMQ, bdp=bdp, bta=bta,
                btb=btb, bucket_hist=hist, vq_bIAQ=bIAQ, vq_bIAD=bIAD,
                vq_bIDQ=bIDQ, frag_indel=frag_indel, mutforms=mutforms)
            fq_res = device_chain.fq_result(
                out, gap_info, famgrp, ref_syms, sscs_table, thres, baq,
                baq2, batch, P, cfg)
        route = "device" if out is not None else "host"
        chain_span.set(route=route)
        fam_span.set(route=route)
        pile_span.set(route=pc.route)
    return DeviceRegionResult(bq=bq_res, fq=fq_res, frag_cons=frag_gc,
                              tracks=tracks, baq=baq,
                              baq2=baq2, famgrp=famgrp, ref_syms=ref_syms,
                              region_offset=region_offset, assay_type=assay,
                              families_device=out is not None,
                              pass_c_device=pc.route == "device")


def _host_chain(allev, gap_info, famgrp, table, info, bg, a1, a2, prep,
                thres, baq, baq2, ref_syms, batch, P, cfg, is_normal):
    """The host route of the family chain: region.py's second
    ``prepare.families`` block, statement for statement.  Returns
    (frag_gc, the BQ result, the FQ result)."""
    # shared fragment consensus: sort-free per-fragment stream merge when
    # the native kernel is built (exact parity), else the sorting reduce
    import os as _os
    from ..ops import native_rowpile as nr
    pd_pre = None
    if _os.environ.get("UVC_TPU_DEVICE_PREPARE", "") == "1":
        # on-device prepare: the fragment sort+reduce+consensus (the hot
        # op of updateByRegion3Aln, main.hpp:3665-3742) runs on
        # ops/device_consensus's device instead of the native host kernel
        from ..ops import device_consensus as devcons
        frag = famgrp.frag_of_read[allev.read]
        _, cons6 = devcons.device_reduce_consensus(
            frag, allev.pos, allev.sym, allev.val, P, "max",
            link_m_overridden=True)
        fc6 = cons6
    else:
        # statics mode keeps the consensus rows inside the .so for the
        # pass-D + family chain; the consensus-FASTQ emitter reads
        # res.frag_cons much later (after the statics were reused), so
        # that flag forces a fetch
        fc6 = None
        if nr.has_statics_path() and not cfg.fam_consensus_out_fastq:
            # fused merge: pass D runs inside the fragment flush while
            # the consensus rows are cache-hot
            import numpy as _np
            normMQ = _np.zeros(famgrp.n_frags, dtype=_np.int64)
            if famgrp.n_frags:
                _np.maximum.at(normMQ, famgrp.frag_of_read,
                               table.reads.mapq)
            aDP4 = (info.aDPff + info.aDPfr + info.aDPrf + info.aDPrr)
            fused = nr.frag_cons_with_pass_d(
                allev, famgrp.frag_of_read, famgrp.n_frags, P, bg, aDP4,
                ref_syms, famgrp.frag_strand, normMQ,
                cfg.bias_thres_highBQ, cfg.syserr_mut_region_n_bases)
            if fused is not None:
                fc6, pd_pre = fused
        if fc6 is None:
            fc6 = nr.frag_cons_direct(allev, famgrp.frag_of_read,
                                      famgrp.n_frags, P,
                                      link_m_overridden=True,
                                      fetch=not nr.has_statics_path()
                                      or bool(cfg.fam_consensus_out_fastq))
    if isinstance(fc6, nr.StaticFragCons):
        # rows stay resident in the .so statics: pass_d and the family
        # chain read them in place (no numpy round trip)
        frag_gc = fc6
    elif fc6 is not None:
        frag_gc = cns.GroupConsensus(*fc6)
    else:
        frag = famgrp.frag_of_read[allev.read]
        _, frag_gc = cns.reduce_and_consensus(frag, allev.pos, allev.sym,
                                              allev.val, P, "max",
                                              link_m_overridden=True)

    bdp, bta, btb, hist, vq_bMQ, frag_indel, mutforms = \
        engine_bq.pass_d_fragments(allev, gap_info, table, ref_syms,
                                   famgrp.frag_of_read, famgrp.frag_strand,
                                   P, cfg, info, bg, frag_gc=frag_gc,
                                   batch=batch, precomputed=pd_pre)
    bIAQ, bIAD, bIDQ = engine_bq.final_iid_qualities(bdp, bg, info, hist, P)
    bq_res = engine_bq.BQResult(
        prep=prep, thres=thres, seginfo=info, bg_bqsum=bg, vq_a1BQ=a1,
        vq_a2BQ=a2, vq_bMQ=vq_bMQ, bdp=bdp, bta=bta, btb=btb,
        bucket_hist=hist, vq_bIAQ=bIAQ, vq_bIAD=bIAD, vq_bIDQ=bIDQ,
        frag_indel=frag_indel, mutforms=mutforms)

    sscs_table = sscs.table_from_cfg(cfg)
    fq_res = engine_fq.run_fq(frag_gc, gap_info, famgrp, ref_syms,
                              sscs_table, thres, baq, baq2, table, batch, P,
                              cfg, is_normal)
    return frag_gc, bq_res, fq_res
