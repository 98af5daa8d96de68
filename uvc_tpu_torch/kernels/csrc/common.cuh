// Shared definitions of the packed quality model's kernels
// (capitals_vq.cu, dpv.cu, qual_tail.cu); device_consensus.cu takes its
// HD macro for the radix sort's helpers.
//
// Wire: one thread handles one row r of the packed request.  Its input
// planes are pi[r * ci + in_off[I_x] + s] for symbol s (0..13), its int
// leaves oi[r * coi + out_off[O_x] + s] and its float leaves
// of[r * cof + out_off[O_x] + s].  In the rescued mode the float wire pf
// (the regime's float, cpf = 28 columns) holds the row's tumor allele
// fractions: tpfa_dpv at pf[r * cpf + tp_d + s], tpfa_qual at
// pf[r * cpf + tp_q + s]; otherwise pf is null.  The mode (is_tumor_only,
// rescued) is a field of the launch argument, not a separate build.  The enums below name the planes, leaves
// and cfg fields in the order of uvc_tpu_torch/kernels/layout.py
// (IN_NAMES, OUT_NAMES) and model/params.py (CFG_FIELDS); a CPU test
// parses this file to hold the orders equal.
//
// Numbers: FT/IT are the regime's float/int (double/int64_t or
// float/int32_t).  The JAX reference computes a few values from int32
// planes in float32 in both regimes; those are written with `float`.
// Float -> int conversion truncates and saturates with NaN -> 0 (to_int),
// min/max propagate NaN, `fdiv` is floor division of ints and `rint`
// rounds half to even, all as XLA does.  The sources are compiled with
// --fmad=false so that every + - * / rounds on its own.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#define ROWFN __device__ __forceinline__
#define DEVCONST __constant__
#else  // the row functions also build as plain C++ (a host-side check)
#define HD inline
#define ROWFN inline
#define DEVCONST
#endif

namespace uvc {

constexpr int NS = 14;

enum In {
    I_APDP, I_APLRI, I_APXM, I_BDP, I_CDP1, I_a1BQf, I_a1BQr, I_a2BM2,
    I_a2BQf_raw, I_a2BQr_raw, I_a2XM2, I_aBQ2, I_aDPff, I_aDPfr, I_aDPrf,
    I_aDPrr, I_aLB1, I_aLB2, I_aLBL, I_aLI1, I_aLI2, I_aLIT, I_aLIr, I_aLP1,
    I_aLP2, I_aLPL, I_aMQs, I_aNC, I_aP1, I_aP2, I_aP3, I_aPF1, I_aPF2,
    I_aRB1, I_aRB2, I_aRBL, I_aRI1, I_aRI2, I_aRIT, I_aRIf, I_aRP1, I_aRP2,
    I_aRPL, I_bDPa, I_bDPf, I_bDPr, I_bIADb, I_bIAQb, I_bMQ_raw, I_bTAf,
    I_bTAr, I_bTBf, I_bTBr, I_c2BQ2, I_c2LB1, I_c2LB2, I_c2LBL, I_c2LP0,
    I_c2LP1, I_c2LP2, I_c2LPL, I_c2RB1, I_c2RB2, I_c2RBL, I_c2RP0, I_c2RP1,
    I_c2RP2, I_c2RPL, I_cDP0a, I_cDP12f, I_cDP12r, I_cDP1f, I_cDP1r,
    I_cDP21f, I_cDP21r, I_cDP2f, I_cDP2r, I_cDP3f, I_cDP3r, I_cDPDf, I_cDPDr,
    I_cDPMf, I_cDPMr, I_cDPmf, I_cDPmr, I_cIADf, I_cIADr, I_cIAQf, I_cIAQr,
    I_cIDQf, I_cIDQr, I_ctx_repeatnum, I_ctx_unitlen, I_dDP1, I_dDP2,
    I_del1_cdepth, I_del_cdepth, I_gapLen, I_hp_red, I_ins1_cdepth,
    I_ins_cdepth, I_minABQ_indel_p, I_minABQ_snv_p, I_ref_syms,
    I_rtr1_tracklen_3, I_rtr1_unitlen_3, I_rtr2_anyTR_tracklen_3,
    I_rtr2_tracklen_3, I_rtr2_unitlen_3, I_tki_et2, I_cand, N_IN
};

enum Out {
    O_A1BQf, O_A1BQr, O_ABQ2, O_AD, O_ADPff, O_ADPfr, O_ADPrf, O_ADPrr,
    O_ALB2, O_ALBL, O_ALI2, O_ALIr, O_ALP1, O_ALP2, O_ALPL, O_AMQs, O_AP1,
    O_AP2, O_APF2, O_ARB2, O_ARBL, O_ARI2, O_ARIf, O_ARP1, O_ARP2, O_ARPL,
    O_BDPb_l, O_BDPb_r, O_BTA, O_BTAf, O_BTAr, O_BTB, O_BTBf, O_BTBr,
    O_C2BQ2, O_C2LB2, O_C2LBL, O_C2LP0, O_C2LP2, O_C2LPL, O_C2RB2, O_C2RBL,
    O_C2RP0, O_C2RP2, O_C2RPL, O_CDP12, O_CDP12b_l, O_CDP12b_r, O_CDP1b_l,
    O_CDP1b_r, O_CDP1v, O_CDP1v_nn, O_CDP1w, O_CDP1w_nn, O_CDP1x, O_CDP1x_nn,
    O_CDP2, O_CDP21b_l, O_CDP21b_r, O_CDP2b_l, O_CDP2b_r, O_CDP2v,
    O_CDP2v_nn, O_CDP2w, O_CDP2w_nn, O_CDP2x, O_CDP2x_nn, O_CDP3, O_CDP3b_l,
    O_CDP3b_r, O_CDPD, O_CDPDb_l, O_CDPDb_r, O_CDPMb_l, O_CDPMb_r, O_CDPmb_l,
    O_CDPmb_r, O_CONTQ, O_DDP1, O_DDP2, O_FTS_aAlignL_0, O_FTS_aAlignL_1,
    O_FTS_aAlignR_0, O_FTS_aAlignR_1, O_FTS_aBQXM_0, O_FTS_aBQXM_1,
    O_FTS_aInsertSize_0, O_FTS_aInsertSize_1, O_FTS_aPositionL_0,
    O_FTS_aPositionL_1, O_FTS_aPositionR_0, O_FTS_aPositionR_1,
    O_FTS_aStrand_0, O_FTS_aStrand_1, O_FTS_abPositionL_0,
    O_FTS_abPositionL_1, O_FTS_abPositionR_0, O_FTS_abPositionR_1,
    O_FTS_bcDup_0, O_FTS_bcDup_1, O_FTS_c0Orientation_0,
    O_FTS_c0Orientation_1, O_FTS_c2AlignL_0, O_FTS_c2AlignL_1,
    O_FTS_c2AlignR_0, O_FTS_c2AlignR_1, O_FTS_c2Orientation_0,
    O_FTS_c2Orientation_1, O_FTS_c2PositionL_0, O_FTS_c2PositionL_1,
    O_FTS_c2PositionR_0, O_FTS_c2PositionR_1, O_FTS_c2StrictPosL_0,
    O_FTS_c2StrictPosL_1, O_FTS_c2StrictPosR_0, O_FTS_c2StrictPosR_1,
    O_FTS_cbDup_0, O_FTS_cbDup_1, O__b4c_0, O__b4c_1, O__b4c_2, O__b4c_3,
    O__bDP_allele, O__c4c_0, O__c4c_1, O__c4c_2, O__c4c_3, O__rawq, O__tlodq,
    O__vcfqual, O_a2BQf, O_a2BQr, O_aAaMQ, O_aBQ, O_aBQQ, O_bAD, O_bIAQ,
    O_bMQ, O_bMQQ, O_bNMQ, O_bNMa, O_bNMb, O_bTINQ, O_cDP1v, O_cDP1w,
    O_cDP1x, O_cDP2v, O_cDP2w, O_cDP2x, O_cIAQ, O_cMmQ, O_cPCQ1, O_cPCQ2,
    O_cPLQ1, O_cPLQ2, O_cTINQ, O_cVQ1, O_cVQ2, O_dVQinc, O_enable_tier2,
    O_gVQ1, O_nAFA_0, O_nAFA_1, O_nAFA_2, O_nAFA_3, O_nAFA_4, O_nAFA_5,
    O_nAFA_6, O_nAFA_7, O_nAFA_8, O_nBCFA_0, O_nBCFA_1, O_nBCFA_2, O_nBCFA_3,
    O_nBCFA_4, O_nBCFA_5, O_nBCFA_6, O_nBCFA_7, O_nBCFA_8, O_nBCFA_9,
    O_nNFA_0, O_nNFA_1, O_nNFA_2, O_nNFA_3, O_nNFA_4, O_nNFA_5, O_nPF_B,
    O_nPF_P, O_short_frag, N_OUT
};

enum Cfg {
    C_bias_FA_powerlaw_noUMI_phred_inc_indel,
    C_bias_FA_powerlaw_noUMI_phred_inc_snv,
    C_bias_FA_powerlaw_withUMI_phred_inc_indel,
    C_bias_FA_powerlaw_withUMI_phred_inc_snv,
    C_bias_FA_pseudocount_indel_in_read,
    C_bias_orientation_min_effective_allelefrac, C_bias_prior_DPadd_perc,
    C_bias_prior_var_DP_mul, C_bias_priorfreq_indel_in_read_div,
    C_bias_priorfreq_indel_in_str_div2, C_bias_priorfreq_indel_in_var_div2,
    C_bias_priorfreq_ipos_indel, C_bias_priorfreq_ipos_snv,
    C_bias_priorfreq_orientation_indel_base,
    C_bias_priorfreq_orientation_snv_base, C_bias_priorfreq_pos,
    C_bias_priorfreq_strand_indel, C_bias_priorfreq_strand_snv_base,
    C_bias_priorfreq_var_in_str_div2,
    C_bias_reduction_by_high_sequencingDP_min_n_altDepth,
    C_bias_reduction_by_high_sequencingDP_min_n_totDepth,
    C_bias_thres_FTS_FA, C_contam_any_mul_frac, C_contam_t2n_mul_frac,
    C_fam_bias_overseq_perc, C_fam_indel_nonUMI_phred_dec_per_fold_overseq,
    C_fam_min_n_copies, C_fam_min_n_copies_DPxAD, C_fam_min_overseq_perc,
    C_fam_phred_dscs_all, C_fam_phred_dscs_inc_max, C_fam_phred_dscs_max,
    C_fam_phred_pow_dscs_all_origin, C_fam_phred_pow_sscs_indel_origin,
    C_fam_phred_pow_sscs_snv_origin,
    C_fam_phred_pow_sscs_transversion_AT_TA_origin,
    C_fam_phred_sscs_transition_AT_GC, C_fam_phred_sscs_transition_CG_TA,
    C_fam_phred_sscs_transversion_CG_AT, C_fam_phred_sscs_transversion_other,
    C_fam_thres_emperr_all_flat_indel, C_fam_thres_highBQ_indel,
    C_fam_thres_highBQ_snv, C_fam_tier3DP_bias_overseq_perc,
    C_germ_phred_het3al_indel, C_germ_phred_het3al_snp,
    C_germ_phred_hetero_indel, C_germ_phred_hetero_snp,
    C_germ_phred_homalt_indel, C_germ_phred_homalt_snp,
    C_indel_del_to_ins_err_ratio, C_indel_ins_penal_pseudocount,
    C_indel_multiallele_diffpos_penal, C_indel_multiallele_samepos_penal,
    C_indel_multiallele_soma_penal_thres, C_indel_polymerase_size,
    C_indel_polymerase_slip_rate, C_indel_str_repeatsize_max,
    C_indel_tetraallele_germline_penal_thres,
    C_indel_tetraallele_germline_penal_value, C_inferred_maxMQ,
    C_inferred_sequencing_platform, C_lib_nonwgs_ad_pseudocount,
    C_lib_nonwgs_clip_penal_min_indelsize,
    C_lib_nonwgs_normal_full_self_rescue_fa,
    C_lib_nonwgs_normal_max_rescued_MQ,
    C_lib_nonwgs_normal_min_self_rescue_fa_ratio, C_lib_wgs_min_avg_fraglen,
    C_lib_wgs_normal_max_rescued_MQ, C_microadjust_bias_pos_indel_fold,
    C_microadjust_bias_pos_indel_misma_to_indel_ratio,
    C_microadjust_counterbias_pos_fold_ratio,
    C_microadjust_counterbias_pos_odds_ratio,
    C_microadjust_dedup_absence_indel_penalty,
    C_microadjust_fam_binom_qual_halving_thres,
    C_microadjust_germline_mix_with_del_snv_penalty,
    C_microadjust_longfrag_sidelength_max,
    C_microadjust_longfrag_sidelength_min,
    C_microadjust_longfrag_sidelength_zeroMQpenalty,
    C_microadjust_nobias_pos_indel_bMQ,
    C_microadjust_nobias_pos_indel_maxlen,
    C_microadjust_nobias_pos_indel_misma_to_indel_ratio,
    C_microadjust_nobias_pos_indel_perc,
    C_microadjust_nobias_strand_all_fold,
    C_microadjust_orientation_absence_snv_penalty,
    C_microadjust_refbias_indel_max,
    C_microadjust_strand_absence_snv_penalty,
    C_microadjust_strand_orientation_absence_DP_fold,
    C_microadjust_syserr_MQ_NMR_tn_syserr_no_penal_qual_max,
    C_microadjust_syserr_MQ_NMR_tn_syserr_no_penal_qual_min, C_nobias_flag,
    C_nobias_pos_indel_lenfrac_thres, C_nobias_pos_indel_str_track_len,
    C_penal4lowdep, C_powlaw_amplicon_allele_fraction_coef,
    C_powlaw_anyvar_base, C_powlaw_exponent, C_primer_flag, C_primerlen,
    C_primerlen2, C_syserr_BQ_bmratio_q_add, C_syserr_BQ_bmratio_q_max,
    C_syserr_BQ_prior, C_syserr_BQ_sbratio_q_add, C_syserr_BQ_sbratio_q_max,
    C_syserr_BQ_strand_favor_mul, C_syserr_BQ_xmratio_q_add,
    C_syserr_BQ_xmratio_q_max, C_syserr_MQ_NMR_altfrac_coef,
    C_syserr_MQ_NMR_expfrac, C_syserr_MQ_NMR_nonaltfrac_coef,
    C_syserr_MQ_NMR_pl_exponent, C_syserr_MQ_max, C_syserr_MQ_min,
    C_syserr_MQ_nonref_base, C_tn_q_inc_max, C_tn_q_inc_max_sscs_CG_AT,
    C_tn_q_inc_max_sscs_other, C_tn_syserr_norm_devqual, N_CFG
};

// The launch argument: column offsets, the request's mode, the SSCS phred
// table and the cfg vector.  kernels/layout.py ``Layout`` mirrors it field
// for field.
struct Layout {
    int ci, coi, cof;
    int cpf, tp_d, tp_q;          // pf columns (0 without pf) and offsets
    int is_tumor_only, rescued;   // the request's mode
    int in_off[N_IN];
    int out_off[N_OUT];
    int sscs[NS * NS];
    double cfg[N_CFG];
};

// ---- numbers, as XLA computes them --------------------------------------

HD double xlog(double x) { return log(x); }
HD float xlog(float x) { return logf(x); }
HD double xexp(double x) { return exp(x); }
HD float xexp(float x) { return expf(x); }
HD double xlog1p(double x) { return log1p(x); }
HD float xlog1p(float x) { return log1pf(x); }
HD double xlog10(double x) { return log10(x); }
HD float xlog10(float x) { return log10f(x); }
HD double xsqrt(double x) { return sqrt(x); }
HD float xsqrt(float x) { return sqrtf(x); }
HD double xpow(double x, double y) { return pow(x, y); }
HD float xpow(float x, float y) { return powf(x, y); }
HD double xrint(double x) { return rint(x); }
HD float xrint(float x) { return rintf(x); }
HD double xfloor(double x) { return floor(x); }
HD float xfloor(float x) { return floorf(x); }
HD double xtrunc(double x) { return trunc(x); }
HD float xtrunc(float x) { return truncf(x); }

template <typename T> HD bool isnan_(T x) { return x != x; }

// jnp.maximum / jnp.minimum: NaN if either operand is NaN
template <typename T> HD T fmax_(T a, T b) {
    return (isnan_(a) || isnan_(b)) ? a + b : (a > b ? a : b);
}
template <typename T> HD T fmin_(T a, T b) {
    return (isnan_(a) || isnan_(b)) ? a + b : (a < b ? a : b);
}
template <typename T> HD T imax(T a, T b) { return a > b ? a : b; }
template <typename T> HD T imin(T a, T b) { return a < b ? a : b; }
template <typename T> HD T iclip(T x, T lo, T hi) { return imin(imax(x, lo), hi); }
template <typename T> HD T fclip(T x, T lo, T hi) { return fmin_(fmax_(x, lo), hi); }

// XLA's float -> int convert: truncate, saturate, NaN -> 0
template <typename IT, typename F> HD IT to_int(F x) {
    const F bound = (F)((sizeof(IT) == 8) ? 9223372036854775808.0 : 2147483648.0);
    if (isnan_(x)) return 0;
    if (x >= bound) return (IT)((sizeof(IT) == 8) ? INT64_MAX : INT32_MAX);
    if (x < -bound) return (IT)((sizeof(IT) == 8) ? INT64_MIN : INT32_MIN);
    return (IT)x;
}

// jnp.round(x).astype(int): half to even, then convert
template <typename IT, typename F> HD IT round_i(F x) { return to_int<IT>(xrint(x)); }

// integer floor division (jnp //); b != 0 at every call site
template <typename T> HD T fdiv(T a, T b) {
    T q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
    return q;
}

// C division truncating toward zero (the model's tdiv)
template <typename T> HD T tdiv(T a, T b) { return a / b; }

}  // namespace uvc

// Row accessors, for use inside a row function that has `in`, `oi`, `of`
// (this row's slices of pi/oi/of), `L` (the Layout) and types FT/IT.
#define PI(name, s) ((IT)in[L.in_off[uvc::I_##name] + (s)])
#define PI1(name) ((IT)in[L.in_off[uvc::I_##name]])
#define OI(name, s) oi[L.out_off[uvc::O_##name] + (s)]
#define OF(name, s) of[L.out_off[uvc::O_##name] + (s)]
#define CFI(name) ((IT)L.cfg[uvc::C_##name])
#define CFF(name) ((FT)L.cfg[uvc::C_##name])

// The extern "C" launcher of a kernel for one regime: one thread per row,
// returns cudaGetLastError() after the launch.
#define UVC_LAUNCHER(kname, regime, FT_, IT_)                                  \
    extern "C" int uvc_##kname##_##regime(const void* pi, const void* pf,     \
                                          void* oi, void* of, long long R,    \
                                          const void* layout, void* stream) { \
        const uvc::Layout& L = *static_cast<const uvc::Layout*>(layout);      \
        const int threads = 128;                                              \
        const long long blocks = (R + threads - 1) / threads;                 \
        kname##_kernel<FT_, IT_><<<(unsigned)blocks, threads, 0,              \
                                   static_cast<cudaStream_t>(stream)>>>(      \
            static_cast<const IT_*>(pi), static_cast<const FT_*>(pf),         \
            static_cast<IT_*>(oi), static_cast<FT_*>(of), R, L);              \
        return (int)cudaGetLastError();                                       \
    }

// The __global__ kernel around a row function `kname##_row<FT, IT>`; the
// row function gets its row of pf, or null.
#define UVC_KERNEL(kname)                                                     \
    template <typename FT, typename IT>                                       \
    __global__ void __launch_bounds__(128) kname##_kernel(                    \
        const IT* __restrict__ pi, const FT* __restrict__ pf,                 \
        IT* __restrict__ oi, FT* __restrict__ of, long long R,                \
        const uvc::Layout L) {                                                \
        long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;       \
        if (r >= R) return;                                                   \
        kname##_row<FT, IT>(pi + r * L.ci, pf ? pf + r * L.cpf : nullptr,     \
                            oi + r * L.coi, of + r * L.cof, L);               \
    }
