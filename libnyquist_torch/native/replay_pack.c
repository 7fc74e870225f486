/* Host assembly of the iy-split PVQ leaf plane (ops/celt_replay.py
 * build_replay_arrays): bucket-by-codeword-length packing of the
 * device-cwrsi leaves of a stream (hundreds of thousands).  Pure data
 * movement: one O(n) pass in place of a gather/sort pipeline in NumPy. */

#include <stdint.h>
#include <string.h>

#define LF_PVQ_IDX_TYPE 5   /* must match ops/celt_replay.py LF_PVQ_IDX */

static int bucket_of (int len, const int32_t *edges, int nedges)
{
    int b = 0;

    while (b < nedges && len > edges [b])
        b++;
    return b;                   /* == nedges: exceeds all buckets */
}

/* pass 1: per-bucket counts (counts has nedges+1 slots; the last one
 * collects out-of-range leaves the caller rejects). Returns the leaf
 * type tag checked so Python can assert it matches. */
int64_t celt_pvq_bucket_count (const int8_t *lf_type,
                               const int16_t *lf_len, int64_t nleaf,
                               const int32_t *edges, int nedges,
                               int64_t *counts)
{
    int64_t i;

    memset (counts, 0, sizeof (int64_t) * (size_t) (nedges + 1));
    for (i = 0; i < nleaf; i++)
        if (lf_type [i] == LF_PVQ_IDX_TYPE)
            counts [bucket_of (lf_len [i], edges, nedges)]++;
    return LF_PVQ_IDX_TYPE;
}

/* pass 2: fill the concatenated bucket-major output arrays.
 * bucket_base[b] = first output slot of bucket b (cursor starts
 * there); rs_slot[leaf] = its output slot (or stays -1).  Output
 * arrays are pre-filled with their pad values by the caller. */
void celt_pvq_bucket_fill (const int8_t *lf_type, const int16_t *lf_len,
                           const int32_t *lf_frame, const int8_t *lf_call,
                           const int8_t *lf_band, const int16_t *lf_off,
                           const int32_t *lf_k, const uint32_t *lf_seed,
                           int64_t nleaf, const int32_t *edges,
                           int nedges, const int64_t *bucket_base,
                           const int64_t *band_off, int64_t nmax,
                           int64_t nframes,
                           int32_t *out_n, int32_t *out_k,
                           uint32_t *out_i, int32_t *out_tgt,
                           int64_t *rs_slot)
{
    int64_t cursor [64];
    int64_t i;
    int b;

    for (b = 0; b <= nedges && b < 64; b++)
        cursor [b] = bucket_base [b];

    for (i = 0; i < nleaf; i++) {
        int64_t slot, rows, tgt;

        if (lf_type [i] != LF_PVQ_IDX_TYPE)
            continue;
        b = bucket_of (lf_len [i], edges, nedges);
        slot = cursor [b]++;
        /* channel-MAJOR dense-plane rows (c*F + f): the device plane
         * reshapes to [2, F, nmax] for free, so no channel-minor
         * tensor (and no 64x lane-padded relayout) can ever form --
         * see ops/celt_replay.py _replay_builder. */
        rows = (int64_t) lf_call [i] * nframes + lf_frame [i];
        tgt = rows * nmax + band_off [lf_band [i]] + lf_off [i];
        out_n [slot] = lf_len [i];
        out_k [slot] = lf_k [i];
        out_i [slot] = lf_seed [i];
        out_tgt [slot] = (int32_t) tgt;
        rs_slot [i] = slot;
    }
}
