/* Cross-block SIMD decorrelation for WavPack.
 *
 * Every WavPack block is independently decodable: it carries its own
 * decorrelation terms/weights/history and entropy state in metadata
 * (reference: wavpack/src/unpack.c unpack_samples applies the passes
 * per block from per-block decorr specs).  The per-sample recurrence
 * inside one block is serial, but ACROSS blocks there is no dependency
 * at all — so eight blocks that declare the same term sequence can run
 * every decorrelation pass in lockstep, one block per AVX2 lane.  This
 * turns the latency-bound scalar chains (~11 cycles per stereo pair per
 * pass, measured) into 8-wide vector steps whose chain latency is
 * amortized over 8 blocks.
 *
 * Lane semantics are bit-identical to wv_words.c wv_decorr_stereo /
 * wv_decorr_mono (which mirror unpack.c decorr_stereo_pass /
 * decorr_mono_pass): int32 wrapping multiplies, the split 16-bit
 * apply-weight path, and the sign-driven weight updates are reproduced
 * exactly per lane (all truncations happen at the same widths).
 *
 * Processing is chunked (CH samples per chunk) and pass-major inside a
 * chunk: transpose chunk -> pass 0..n-1 over the chunk -> joint-stereo
 * undo -> transpose back.  Pass state (weights, history) is carried
 * across chunks, so the result equals running each pass over the whole
 * block sequentially.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>

#define WV_LANES 8
#define WV_CHUNK 1024

typedef struct {
    __m256i wa, wb;         /* weights per lane */
    __m256i sa[8], sb[8];   /* history windows per lane */
    int term, m, k;
    __m256i delta;          /* per-lane delta */
} vstate;

/* exact vector twin of wv_words.c wv_apply_weight: the short path when
 * the sample fits in int16 ((int32)((int64)w*s) wraps == mullo), the
 * split path otherwise; truncations at the same points. */
__attribute__((target("avx2"), always_inline))
static inline __m256i vw_apply(__m256i w, __m256i s)
{
    const __m256i c512 = _mm256_set1_epi32(512);
    const __m256i lo16 = _mm256_set1_epi32(0xffff);

    /* short: ((int32)(w*s) + 512) >> 10 */
    __m256i shrt = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_mullo_epi32(w, s), c512), 10);

    /* is_short = (s == (int16)s); on 16-bit-era content every lane is
     * short almost always — skip the split path entirely then (the
     * branch is near-perfectly predicted) */
    __m256i sext16 = _mm256_srai_epi32(_mm256_slli_epi32(s, 16), 16);
    __m256i is_short = _mm256_cmpeq_epi32(s, sext16);
    if (__builtin_expect(
            _mm256_movemask_epi8(is_short) == -1, 1))
        return shrt;

    /* long: lo = (int32)(((int64)(s & 0xffff) * w) >> 9)
     *       hi = (int32)((int64)((s & ~0xffff) >> 9) * w)   (wraps)
     *       r  = ((int32)(lo + hi + 1)) >> 1                (wraps)  */
    __m256i slo = _mm256_and_si256(s, lo16);
    /* 32x32->64 products, even and odd 32-bit lanes */
    __m256i pe = _mm256_mul_epi32(slo, w);
    __m256i po = _mm256_mul_epi32(_mm256_srli_epi64(slo, 32),
                                  _mm256_srli_epi64(w, 32));
    /* >>9 on the 64-bit product then truncate to 32: the low 32 bits
     * of an arithmetic >>9 equal those of a logical >>9 */
    pe = _mm256_srli_epi64(pe, 9);
    po = _mm256_srli_epi64(po, 9);
    __m256i lo = _mm256_blend_epi32(pe, _mm256_slli_epi64(po, 32), 0xAA);
    __m256i hi = _mm256_mullo_epi32(
        _mm256_srai_epi32(_mm256_andnot_si256(lo16, s), 9), w);
    __m256i lng = _mm256_srai_epi32(
        _mm256_add_epi32(_mm256_add_epi32(lo, hi),
                         _mm256_set1_epi32(1)), 1);

    return _mm256_blendv_epi8(lng, shrt, is_short);
}

/* WV_UPDATE_WEIGHT: if (s && r) w += (d ^ sign) - sign, sign=(s^r)>>31 */
__attribute__((target("avx2"), always_inline))
static inline __m256i vw_update(__m256i w, __m256i d, __m256i s, __m256i r)
{
    __m256i zero = _mm256_setzero_si256();
    __m256i nz = _mm256_andnot_si256(
        _mm256_or_si256(_mm256_cmpeq_epi32(s, zero),
                        _mm256_cmpeq_epi32(r, zero)),
        _mm256_set1_epi32(-1));
    __m256i sign = _mm256_srai_epi32(_mm256_xor_si256(s, r), 31);
    __m256i adj = _mm256_sub_epi32(_mm256_xor_si256(d, sign), sign);
    return _mm256_add_epi32(w, _mm256_and_si256(nz, adj));
}

/* WV_UPDATE_WEIGHT_CLIP: if (s && r) { sign=(s^r)>>31;
 *   w = (w^sign) + (d - sign); if (w > 1024) w = 1024;
 *   w = (w^sign) - sign; } */
__attribute__((target("avx2"), always_inline))
static inline __m256i vw_update_clip(__m256i w, __m256i d,
                                     __m256i s, __m256i r)
{
    __m256i zero = _mm256_setzero_si256();
    __m256i nz = _mm256_andnot_si256(
        _mm256_or_si256(_mm256_cmpeq_epi32(s, zero),
                        _mm256_cmpeq_epi32(r, zero)),
        _mm256_set1_epi32(-1));
    __m256i sign = _mm256_srai_epi32(_mm256_xor_si256(s, r), 31);
    __m256i t = _mm256_add_epi32(_mm256_xor_si256(w, sign),
                                 _mm256_sub_epi32(d, sign));
    t = _mm256_min_epi32(t, _mm256_set1_epi32(1024));
    t = _mm256_sub_epi32(_mm256_xor_si256(t, sign), sign);
    /* w ^ ((w ^ t) & nz), not _mm256_blendv_epi8(w, t, nz): gcc 12 at
     * -O1 and above with AVX-512 enabled (-march=native on such a host)
     * compiles the blend inside the negative-term loops so that the
     * weights never move */
    return _mm256_xor_si256(w, _mm256_and_si256(_mm256_xor_si256(w, t), nz));
}

/* In-place 8x8 int32 transpose of rows r[0..7] (unpack/permute
 * network: 32-bit pairs -> 64-bit quads -> 128-bit halves). */
__attribute__((target("avx2"), always_inline))
static inline void vw_tr8x8(__m256i r[8])
{
    __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
    __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
    __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
    __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
    __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
    __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
    __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
    __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
    __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
    r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
    r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
    r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
    r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
    r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
    r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
    r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
    r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

/* One pass over one transposed chunk.  Lp/Rp are [n][8] lane-major. */
__attribute__((target("avx2")))
static void vw_pass_stereo(vstate *st, int32_t *Lp, int32_t *Rp, int n)
{
    __m256i wa = st->wa, wb = st->wb, d = st->delta;
    int term = st->term;

    if (term == 17 || term == 18) {
        __m256i a0 = st->sa[0], a1 = st->sa[1];
        __m256i b0 = st->sb[0], b1 = st->sb[1];
        for (int i = 0; i < n; i++) {
            __m256i sam_a, sam_b;
            if (term == 17) {
                sam_a = _mm256_sub_epi32(_mm256_add_epi32(a0, a0), a1);
                sam_b = _mm256_sub_epi32(_mm256_add_epi32(b0, b0), b1);
            } else {
                sam_a = _mm256_add_epi32(a0,
                    _mm256_srai_epi32(_mm256_sub_epi32(a0, a1), 1));
                sam_b = _mm256_add_epi32(b0,
                    _mm256_srai_epi32(_mm256_sub_epi32(b0, b1), 1));
            }
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
            a1 = a0; b1 = b0;
            a0 = _mm256_add_epi32(vw_apply(wa, sam_a), l);
            b0 = _mm256_add_epi32(vw_apply(wb, sam_b), r);
            wa = vw_update(wa, d, sam_a, l);
            wb = vw_update(wb, d, sam_b, r);
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), a0);
            _mm256_storeu_si256((__m256i *)(Rp + i * 8), b0);
        }
        st->sa[0] = a0; st->sa[1] = a1;
        st->sb[0] = b0; st->sb[1] = b1;
    }
    else if (term > 0) {            /* terms 1..8: circular window */
        int m = st->m, k = st->k;
        for (int i = 0; i < n; i++) {
            __m256i sam_a = st->sa[m], sam_b = st->sb[m];
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
            __m256i oa = _mm256_add_epi32(vw_apply(wa, sam_a), l);
            __m256i ob = _mm256_add_epi32(vw_apply(wb, sam_b), r);
            wa = vw_update(wa, d, sam_a, l);
            wb = vw_update(wb, d, sam_b, r);
            st->sa[k] = oa; st->sb[k] = ob;
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), oa);
            _mm256_storeu_si256((__m256i *)(Rp + i * 8), ob);
            m = (m + 1) & 7;
            k = (k + 1) & 7;
        }
        st->m = m; st->k = k;
    }
    else if (term == -1) {
        __m256i a0 = st->sa[0];
        for (int i = 0; i < n; i++) {
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
            __m256i sam = _mm256_add_epi32(l, vw_apply(wa, a0));
            wa = vw_update_clip(wa, d, a0, l);
            __m256i nb = _mm256_add_epi32(r, vw_apply(wb, sam));
            wb = vw_update_clip(wb, d, sam, r);
            a0 = nb;
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), sam);
            _mm256_storeu_si256((__m256i *)(Rp + i * 8), nb);
        }
        st->sa[0] = a0;
    }
    else if (term == -2) {
        __m256i b0 = st->sb[0];
        for (int i = 0; i < n; i++) {
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
            __m256i sam = _mm256_add_epi32(r, vw_apply(wb, b0));
            wb = vw_update_clip(wb, d, b0, r);
            __m256i na = _mm256_add_epi32(l, vw_apply(wa, sam));
            wa = vw_update_clip(wa, d, sam, l);
            b0 = na;
            _mm256_storeu_si256((__m256i *)(Rp + i * 8), sam);
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), na);
        }
        st->sb[0] = b0;
    }
    else {                          /* term == -3 */
        __m256i a0 = st->sa[0], b0 = st->sb[0];
        for (int i = 0; i < n; i++) {
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
            __m256i sam_a = _mm256_add_epi32(l, vw_apply(wa, a0));
            wa = vw_update_clip(wa, d, a0, l);
            __m256i sam_b = _mm256_add_epi32(r, vw_apply(wb, b0));
            wb = vw_update_clip(wb, d, b0, r);
            b0 = sam_a;             /* unpack.c -3: cross-swap history */
            a0 = sam_b;
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), sam_a);
            _mm256_storeu_si256((__m256i *)(Rp + i * 8), sam_b);
        }
        st->sa[0] = a0; st->sb[0] = b0;
    }
    st->wa = wa; st->wb = wb;
}

__attribute__((target("avx2")))
static void vw_pass_mono(vstate *st, int32_t *Lp, int n)
{
    __m256i wa = st->wa, d = st->delta;
    int term = st->term;

    if (term == 17 || term == 18) {
        __m256i a0 = st->sa[0], a1 = st->sa[1];
        for (int i = 0; i < n; i++) {
            __m256i sam;
            if (term == 17)
                sam = _mm256_sub_epi32(_mm256_add_epi32(a0, a0), a1);
            else    /* (3*a0 - a1) >> 1, wrapping as the scalar pass */
                sam = _mm256_srai_epi32(_mm256_sub_epi32(
                    _mm256_add_epi32(_mm256_add_epi32(a0, a0), a0), a1), 1);
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            a1 = a0;
            a0 = _mm256_add_epi32(vw_apply(wa, sam), l);
            wa = vw_update(wa, d, sam, l);
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), a0);
        }
        st->sa[0] = a0; st->sa[1] = a1;
    }
    else {                          /* terms 1..8 */
        int m = st->m, k = st->k;
        for (int i = 0; i < n; i++) {
            __m256i sam = st->sa[m];
            __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
            __m256i oa = _mm256_add_epi32(vw_apply(wa, sam), l);
            wa = vw_update(wa, d, sam, l);
            st->sa[k] = oa;
            _mm256_storeu_si256((__m256i *)(Lp + i * 8), oa);
            m = (m + 1) & 7;
            k = (k + 1) & 7;
        }
        st->m = m; st->k = k;
    }
    st->wa = wa;
}

/* Entry: run all passes (+ optional joint-stereo undo) for 8 blocks in
 * lockstep.  bufs: 8 pointers to each block's residual/output buffer
 * (interleaved LR for stereo, plain for mono).  deltas/weights/sa/sb
 * are lane-major: deltas[np][8], weights[np][2][8], sa/sb[np][8][8]
 * (pass, history index, lane).  Returns 1 on success, 0 when the CPU
 * lacks AVX2 or a term is out of range (caller falls back to scalar).
 * Final weight/history state is written back lane-major (callers that
 * need per-block continuation state read it from there). */
__attribute__((target("avx2")))
static int wv_decorr_simd8_impl(int npasses, const int32_t *terms,
                                const int32_t *deltas, int32_t *weights,
                                int32_t *sa, int32_t *sb,
                                int32_t **bufs, int64_t nsamples,
                                int mono, int joint)
{
    vstate st[16];
    for (int p = 0; p < npasses; p++) {
        st[p].term = terms[p];
        st[p].delta = _mm256_loadu_si256((const __m256i *)(deltas + p * 8));
        st[p].wa = _mm256_loadu_si256((const __m256i *)(weights + p * 16));
        st[p].wb = _mm256_loadu_si256(
            (const __m256i *)(weights + p * 16 + 8));
        for (int j = 0; j < 8; j++) {
            st[p].sa[j] = _mm256_loadu_si256(
                (const __m256i *)(sa + (p * 8 + j) * 8));
            st[p].sb[j] = _mm256_loadu_si256(
                (const __m256i *)(sb + (p * 8 + j) * 8));
        }
        st[p].m = 0;
        st[p].k = st[p].term & 7;
    }

    int32_t *Lp = (int32_t *)malloc(2 * WV_CHUNK * 8 * sizeof(int32_t));
    if (!Lp)
        return 0;
    int32_t *Rp = Lp + WV_CHUNK * 8;

    for (int64_t c0 = 0; c0 < nsamples; c0 += WV_CHUNK) {
        int n = (nsamples - c0 < WV_CHUNK) ? (int)(nsamples - c0)
                                           : WV_CHUNK;
        int n8 = n & ~7;
        /* gather: lane-major chunk planes (8x8 transpose strips; the
         * stereo source is additionally LR-interleaved per lane) */
        if (mono) {
            for (int i = 0; i < n8; i += 8) {
                __m256i r[8];
                for (int ln = 0; ln < 8; ln++)
                    r[ln] = _mm256_loadu_si256(
                        (const __m256i *)(bufs[ln] + c0 + i));
                vw_tr8x8(r);
                for (int j = 0; j < 8; j++)
                    _mm256_storeu_si256((__m256i *)(Lp + (i + j) * 8),
                                        r[j]);
            }
            for (int ln = 0; ln < 8; ln++) {
                const int32_t *src = bufs[ln] + c0;
                for (int i = n8; i < n; i++)
                    Lp[i * 8 + ln] = src[i];
            }
            for (int p = 0; p < npasses; p++)
                vw_pass_mono(&st[p], Lp, n);
            for (int i = 0; i < n8; i += 8) {
                __m256i r[8];
                for (int j = 0; j < 8; j++)
                    r[j] = _mm256_loadu_si256(
                        (const __m256i *)(Lp + (i + j) * 8));
                vw_tr8x8(r);
                for (int ln = 0; ln < 8; ln++)
                    _mm256_storeu_si256(
                        (__m256i *)(bufs[ln] + c0 + i), r[ln]);
            }
            for (int ln = 0; ln < 8; ln++) {
                int32_t *dst = bufs[ln] + c0;
                for (int i = n8; i < n; i++)
                    dst[i] = Lp[i * 8 + ln];
            }
        } else {
            const __m256i DEINT = _mm256_setr_epi32(0, 2, 4, 6,
                                                    1, 3, 5, 7);
            for (int i = 0; i < n8; i += 8) {
                __m256i l[8], r[8];
                for (int ln = 0; ln < 8; ln++) {
                    const int32_t *src = bufs[ln] + (c0 + i) * 2;
                    __m256i v0 = _mm256_loadu_si256((const __m256i *)src);
                    __m256i v1 = _mm256_loadu_si256(
                        (const __m256i *)(src + 8));
                    __m256i p0 = _mm256_permutevar8x32_epi32(v0, DEINT);
                    __m256i p1 = _mm256_permutevar8x32_epi32(v1, DEINT);
                    l[ln] = _mm256_permute2x128_si256(p0, p1, 0x20);
                    r[ln] = _mm256_permute2x128_si256(p0, p1, 0x31);
                }
                vw_tr8x8(l);
                vw_tr8x8(r);
                for (int j = 0; j < 8; j++) {
                    _mm256_storeu_si256((__m256i *)(Lp + (i + j) * 8),
                                        l[j]);
                    _mm256_storeu_si256((__m256i *)(Rp + (i + j) * 8),
                                        r[j]);
                }
            }
            for (int ln = 0; ln < 8; ln++) {
                const int32_t *src = bufs[ln] + c0 * 2;
                for (int i = n8; i < n; i++) {
                    Lp[i * 8 + ln] = src[i * 2];
                    Rp[i * 8 + ln] = src[i * 2 + 1];
                }
            }
            for (int p = 0; p < npasses; p++)
                vw_pass_stereo(&st[p], Lp, Rp, n);
            if (joint) {            /* unpack.c:199 mid/side undo */
                for (int i = 0; i < n; i++) {
                    __m256i l = _mm256_loadu_si256((__m256i *)(Lp + i * 8));
                    __m256i r = _mm256_loadu_si256((__m256i *)(Rp + i * 8));
                    r = _mm256_sub_epi32(r, _mm256_srai_epi32(l, 1));
                    l = _mm256_add_epi32(l, r);
                    _mm256_storeu_si256((__m256i *)(Lp + i * 8), l);
                    _mm256_storeu_si256((__m256i *)(Rp + i * 8), r);
                }
            }
            for (int i = 0; i < n8; i += 8) {
                __m256i l[8], r[8];
                for (int j = 0; j < 8; j++) {
                    l[j] = _mm256_loadu_si256(
                        (const __m256i *)(Lp + (i + j) * 8));
                    r[j] = _mm256_loadu_si256(
                        (const __m256i *)(Rp + (i + j) * 8));
                }
                vw_tr8x8(l);
                vw_tr8x8(r);
                for (int ln = 0; ln < 8; ln++) {
                    __m256i lo = _mm256_unpacklo_epi32(l[ln], r[ln]);
                    __m256i hi = _mm256_unpackhi_epi32(l[ln], r[ln]);
                    int32_t *dst = bufs[ln] + (c0 + i) * 2;
                    _mm256_storeu_si256((__m256i *)dst,
                        _mm256_permute2x128_si256(lo, hi, 0x20));
                    _mm256_storeu_si256((__m256i *)(dst + 8),
                        _mm256_permute2x128_si256(lo, hi, 0x31));
                }
            }
            for (int ln = 0; ln < 8; ln++) {
                int32_t *dst = bufs[ln] + c0 * 2;
                for (int i = n8; i < n; i++) {
                    dst[i * 2] = Lp[i * 8 + ln];
                    dst[i * 2 + 1] = Rp[i * 8 + ln];
                }
            }
        }
    }

    free(Lp);

    for (int p = 0; p < npasses; p++) {
        _mm256_storeu_si256((__m256i *)(weights + p * 16), st[p].wa);
        _mm256_storeu_si256((__m256i *)(weights + p * 16 + 8), st[p].wb);
        for (int j = 0; j < 8; j++) {
            _mm256_storeu_si256((__m256i *)(sa + (p * 8 + j) * 8),
                                st[p].sa[j]);
            _mm256_storeu_si256((__m256i *)(sb + (p * 8 + j) * 8),
                                st[p].sb[j]);
        }
    }
    return 1;
}

/* plain-ISA dispatcher: validate, check AVX2, then jump to the
 * avx2-targeted implementation */
int wv_decorr_simd8(int npasses, const int32_t *terms,
                    const int32_t *deltas, int32_t *weights,
                    int32_t *sa, int32_t *sb,
                    int32_t **bufs, int64_t nsamples, int mono, int joint)
{
    if (!__builtin_cpu_supports("avx2") || npasses > 16)
        return 0;
    for (int p = 0; p < npasses; p++) {
        int t = terms[p];
        if (!((t >= 1 && t <= 8) || t == 17 || t == 18
              || (!mono && t >= -3 && t <= -1)))
            return 0;
    }
    return wv_decorr_simd8_impl(npasses, terms, deltas, weights, sa, sb,
                                bufs, nsamples, mono, joint);
}

#else  /* non-x86_64 or non-GCC: always fall back to the scalar path */

int wv_decorr_simd8(int npasses, const int32_t *terms,
                    const int32_t *deltas, int32_t *weights,
                    int32_t *sa, int32_t *sb,
                    int32_t **bufs, int64_t nsamples, int mono, int joint)
{
    (void)npasses; (void)terms; (void)deltas; (void)weights;
    (void)sa; (void)sb; (void)bufs; (void)nsamples; (void)mono;
    (void)joint;
    return 0;
}

#endif
