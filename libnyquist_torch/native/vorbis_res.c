/* Native Vorbis packet decode: floor 1 posts and curve, residues 0/1/2,
 * square-polar coupling and the floor-curve multiply (Vorbis I spec
 * sections 7 and 8.6.2; reference: third_party/libvorbis res0.c,
 * floor1.c, codebook.c semantics). The package has no Python version of
 * these parts: streams the whole-stream entry cannot take (floor 0, more
 * than 8 channels) go through the per-packet loop of formats/vorbis.py,
 * which calls the floor 1 and residue entries below one packet at a time.
 *
 * Codebooks arrive as a flat registry built once per logical stream:
 *  - luts:  per-book W<=11-bit LSB-peek LUT, value (entry<<6)|len, -1 miss
 *  - trees: per-book binary-tree node pairs (int32 x2 per node);
 *           child 0 = unset, negative = ~entry leaf (-(entry+1))
 *  - vqs:   per-book [entries, dim] float32 lookup vectors (off -1: none)
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const uint8_t *data;
    int64_t nbytes;
    int64_t pos;    /* bit position */
    int64_t limit;  /* total bits */
    int eop;
} vbits;

static uint32_t vb_peek(const vbits *b, int n) {
    int64_t byte = b->pos >> 3;
    int off = (int)(b->pos & 7);
    int nbytes = (off + n + 7) >> 3;
    uint64_t chunk = 0;
    int i;
    for (i = 0; i < nbytes; i++) {
        uint64_t v = (byte + i < b->nbytes) ? b->data[byte + i] : 0;
        chunk |= v << (8 * i);
    }
    return (uint32_t)((chunk >> off) & ((1u << n) - 1));
}

static int vb_read1(vbits *b) {
    int bit;
    if (b->pos + 1 > b->limit) {
        b->eop = 1;
        b->pos = b->limit;
        return 0;
    }
    bit = (b->data[b->pos >> 3] >> (b->pos & 7)) & 1;
    b->pos += 1;
    return bit;
}

/* Decode one scalar codeword. Returns the entry index, or -1 on
 * end-of-packet (br->eop set, pos at limit) OR invalid codeword
 * (eop NOT set, pos advanced by maxlen -- matching the Python
 * decode_scalar loop, which reads max_len bits before giving up). */
static int book_scalar(vbits *br, const int32_t *lut, int lutw,
                       const int32_t *tree, int maxlen) {
    int cur = 0, dead = 0, ln;
    if (lutw > 0) {
        int32_t v = lut[vb_peek(br, lutw)];
        if (v >= 0) {
            int len = v & 63;
            if (br->pos + len > br->limit) {
                br->eop = 1;
                br->pos = br->limit;
                return -1;
            }
            br->pos += len;
            return v >> 6;
        }
    }
    for (ln = 1; ln <= maxlen; ln++) {
        int b = vb_read1(br);
        if (br->eop) return -1;
        if (!dead) {
            int32_t nxt = tree[2 * cur + b];
            if (nxt < 0) return -nxt - 1;
            if (nxt == 0) dead = 1;
            else cur = nxt;
        }
    }
    return -1; /* invalid codeword: abort decode, eop stays clear */
}

static void residue_impl(
    vbits *brp,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *vqs, const int64_t *vq_off, const int32_t *dims,
    int rtype, int64_t begin, int64_t end, int64_t psize,
    int classifications, int classbook,
    const int32_t *books8 /* [classifications][8] */,
    const uint8_t *do_not_decode, int64_t ch, int64_t n2,
    float *work /* rtype==2: [n2*ch]; else [ch][n2] row-major */)
{
    int64_t vecs = (rtype == 2) ? 1 : ch;
    int64_t parts = (end - begin) / psize;
    int32_t *classifs;
    const int32_t *cb_lut = luts + lut_off[classbook];
    const int32_t *cb_tree = trees + tree_off[classbook];
    int cb_lutw = lut_w[classbook];
    int cb_maxlen = maxlen[classbook];
    int64_t cdim = dims[classbook];
    int passn;
#define br (*brp)

    if (parts <= 0 || cdim <= 0 || classifications <= 0) return;
    classifs = (int32_t *)calloc((size_t)(vecs * parts), sizeof(int32_t));
    if (!classifs) return;

    for (passn = 0; passn < 8; passn++) {
        int64_t pcount = 0;
        while (pcount < parts) {
            int64_t d, v;
            if (passn == 0) {
                for (v = 0; v < vecs; v++) {
                    int64_t tmp;
                    int e;
                    if (rtype != 2 && do_not_decode[v]) continue;
                    e = book_scalar(&br, cb_lut, cb_lutw, cb_tree,
                                    cb_maxlen);
                    if (e < 0) goto done;
                    tmp = e;
                    for (d = cdim - 1; d >= 0; d--) {
                        if (pcount + d < parts)
                            classifs[v * parts + pcount + d] =
                                (int32_t)(tmp % classifications);
                        tmp /= classifications;
                    }
                }
            }
            for (d = 0; d < cdim; d++) {
                if (pcount >= parts) break;
                for (v = 0; v < vecs; v++) {
                    int cls, book;
                    int64_t offset;
                    float *row;
                    const int32_t *b_lut, *b_tree;
                    int b_lutw, b_maxlen;
                    int64_t bdim;
                    const float *bvq;
                    if (rtype != 2 && do_not_decode[v]) continue;
                    cls = classifs[v * parts + pcount];
                    book = books8[cls * 8 + passn];
                    if (book < 0) continue;
                    if (vq_off[book] < 0 || dims[book] <= 0) {
                        br.eop = 1;
                        goto done;
                    }
                    b_lut = luts + lut_off[book];
                    b_tree = trees + tree_off[book];
                    b_lutw = lut_w[book];
                    b_maxlen = maxlen[book];
                    bdim = dims[book];
                    bvq = vqs + vq_off[book];
                    offset = begin + pcount * psize;
                    row = (rtype == 2) ? work : work + v * n2;
                    if (rtype == 0) {
                        int64_t step = psize / bdim, sidx, k;
                        for (sidx = 0; sidx < step; sidx++) {
                            int e = book_scalar(&br, b_lut, b_lutw,
                                                b_tree, b_maxlen);
                            const float *vec;
                            if (e < 0) goto done;
                            vec = bvq + (int64_t)e * bdim;
                            for (k = 0; k < bdim; k++)
                                row[offset + sidx + k * step] += vec[k];
                        }
                    } else {
                        /* row_len guards the final, possibly partial
                         * codeword when psize % bdim != 0 */
                        int64_t row_len = (rtype == 2) ? n2 * ch : n2;
                        int64_t i = 0, k;
                        while (i < psize) {
                            int e = book_scalar(&br, b_lut, b_lutw,
                                                b_tree, b_maxlen);
                            const float *vec;
                            if (e < 0) goto done;
                            if (offset + i + bdim > row_len) {
                                br.eop = 1;
                                goto done;
                            }
                            vec = bvq + (int64_t)e * bdim;
                            for (k = 0; k < bdim; k++)
                                row[offset + i + k] += vec[k];
                            i += bdim;
                        }
                    }
                }
                pcount++;
            }
        }
    }
done:
    free(classifs);
#undef br
}

void vorbis_residue_decode(
    const uint8_t *data, int64_t nbytes, int64_t *st /* [pos, eop] */,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *vqs, const int64_t *vq_off, const int32_t *dims,
    int rtype, int64_t begin, int64_t end, int64_t psize,
    int classifications, int classbook,
    const int32_t *books8, const uint8_t *do_not_decode,
    int64_t ch, int64_t n2, float *work)
{
    vbits br;
    br.data = data;
    br.nbytes = nbytes;
    br.pos = st[0];
    br.limit = nbytes * 8;
    br.eop = (int)st[1];
    residue_impl(&br, luts, lut_off, lut_w, trees, tree_off, maxlen,
                 vqs, vq_off, dims, rtype, begin, end, psize,
                 classifications, classbook, books8, do_not_decode,
                 ch, n2, work);
    st[0] = br.pos;
    st[1] = br.eop;
}

/* ---------------- Floor1 decode + curve (spec sec 7.2.3/7.2.4) -----
 * C translation of our Python Floor1.decode + Floor1.compute
 * (formats/vorbis.py; reference: third_party/libvorbis floor1.c
 * floor1_inverse1/floor1_inverse2 semantics).  The per-post prediction
 * chain is serial by construction; the curve evaluation uses the same
 * closed-form y0 + sign(dy)*floor(|dy|(x-x0)/adx) as the Python.
 */

static uint32_t vb_read(vbits *b, int n) {
    uint32_t v;
    if (n == 0) return 0;
    if (b->pos + n > b->limit) {
        b->eop = 1;
        b->pos = b->limit;
        return 0;
    }
    v = vb_peek(b, n);
    b->pos += n;
    return v;
}

static int64_t render_pt(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                         int64_t x) {
    int64_t dy = y1 - y0;
    int64_t adx = x1 - x0;
    int64_t ady = dy < 0 ? -dy : dy;
    int64_t off = (ady * (x - x0)) / adx;
    return dy < 0 ? y0 - off : y0 + off;
}

/* cfg layout (int32): partitions, mult, posts, rng, bits01, nclasses,
 * partition_class[partitions], class_dim[nc], class_subs[nc],
 * class_book[nc], subclass_books[nc*8] (pad -1), xlist[posts].
 * neighbors: int32 [2*(posts-2)]; sortidx: int32 [posts].
 * st: int64 [pos, eop] in/out.
 * Returns 1 = curve written, 0 = unused channel, -2 = end of packet. */
static int64_t floor_impl(
    vbits *brp,
    const int32_t *cfg, const int32_t *neighbors, const int32_t *sortidx,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *fromdb, int64_t n2, float *curve_out)
{
#define br (*brp)
    int partitions, mult, posts, rng, bits01, nc;
    const int32_t *pclass, *cdim, *csub, *cbook, *subbooks, *xs;
    int ys[288], finaly[288];
    uint8_t step2[288];
    int p, i, offset;

    partitions = cfg[0];
    mult = cfg[1];
    posts = cfg[2];
    rng = cfg[3];
    bits01 = cfg[4];
    nc = cfg[5];
    pclass = cfg + 6;
    cdim = pclass + partitions;
    csub = cdim + nc;
    cbook = csub + nc;
    subbooks = cbook + nc;
    xs = subbooks + nc * 8;
    (void)mult;

    if (!vb_read1(&br)) {
        return br.eop ? -2 : 0;
    }
    memset(ys, 0, sizeof(int) * (size_t)posts);
    ys[0] = (int)vb_read(&br, bits01);
    ys[1] = (int)vb_read(&br, bits01);
    if (br.eop) goto eop;
    offset = 2;
    for (p = 0; p < partitions; p++) {
        int cls = pclass[p];
        int dim = cdim[cls];
        int sub = csub[cls];
        int cval = 0, d;
        if (sub) {
            int bk = cbook[cls];
            cval = book_scalar(&br, luts + lut_off[bk],
                               lut_w[bk], trees + tree_off[bk],
                               maxlen[bk]);
            if (cval < 0) goto eop;
        }
        for (d = 0; d < dim; d++) {
            int bk = subbooks[cls * 8 + (cval & ((1 << sub) - 1))];
            cval >>= sub;
            if (bk >= 0) {
                int v = book_scalar(&br, luts + lut_off[bk],
                                    lut_w[bk], trees + tree_off[bk],
                                    maxlen[bk]);
                if (v < 0) goto eop;
                ys[offset + d] = v;
            }
            else ys[offset + d] = 0;
        }
        offset += dim;
    }

    /* curve computation (spec 7.2.4; Python Floor1.compute) */
    finaly[0] = ys[0];
    finaly[1] = ys[1];
    step2[0] = step2[1] = 1;
    for (i = 2; i < posts; i++) {
        int lo = neighbors[(i - 2) * 2];
        int hi = neighbors[(i - 2) * 2 + 1];
        int64_t predicted = render_pt(xs[lo], finaly[lo], xs[hi],
                                      finaly[hi], xs[i]);
        int val = ys[i];
        int64_t highroom = rng - predicted;
        int64_t lowroom = predicted;
        int64_t room = 2 * (highroom < lowroom ? highroom : lowroom);
        if (val) {
            step2[lo] = 1;
            step2[hi] = 1;
            step2[i] = 1;
            if (val >= room) {
                if (highroom > lowroom)
                    finaly[i] = (int)(val - lowroom + predicted);
                else
                    finaly[i] = (int)(predicted - val + highroom - 1);
            }
            else {
                if (val & 1)
                    finaly[i] = (int)(predicted - ((val + 1) >> 1));
                else
                    finaly[i] = (int)(predicted + (val >> 1));
            }
        }
        else {
            step2[i] = 0;
            finaly[i] = (int)predicted;
        }
    }
    {
        int64_t lx = 0, hx = 0;
        int64_t ly = (int64_t)finaly[sortidx[0]] * cfg[1];
        int j;
        for (j = 1; j < posts; j++) {
            int ii = sortidx[j];
            int64_t hy, x;
            if (!step2[ii]) continue;
            hy = (int64_t)finaly[ii] * cfg[1];
            hx = xs[ii];
            if (lx < n2) {
                int64_t x1 = hx < n2 ? hx : n2;
                int64_t dy = hy - ly;
                int64_t adx = hx - lx;
                int64_t ady = dy < 0 ? -dy : dy;
                for (x = lx; x < x1; x++) {
                    int64_t off = adx ? (ady * (x - lx)) / adx : 0;
                    int64_t y = dy < 0 ? ly - off : ly + off;
                    if (y < 0) y = 0;
                    if (y > 255) y = 255;
                    curve_out[x] = fromdb[y];
                }
            }
            lx = hx;
            ly = hy;
        }
        if (hx < n2) {
            int64_t y = ly < 0 ? 0 : (ly > 255 ? 255 : ly);
            int64_t x;
            for (x = hx; x < n2; x++) curve_out[x] = fromdb[y];
        }
    }
    return 1;

eop:
    br.eop = 1;
    return -2;
#undef br
}

int64_t vorbis_floor1_decode(
    const uint8_t *data, int64_t nbytes, int64_t *st,
    const int32_t *cfg, const int32_t *neighbors, const int32_t *sortidx,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *fromdb, int64_t n2, float *curve_out)
{
    vbits br;
    int64_t rc;
    br.data = data;
    br.nbytes = nbytes;
    br.pos = st[0];
    br.limit = nbytes * 8;
    br.eop = (int)st[1];
    rc = floor_impl(&br, cfg, neighbors, sortidx, luts, lut_off, lut_w,
                    trees, tree_off, maxlen, fromdb, n2, curve_out);
    st[0] = br.pos;
    st[1] = br.eop;
    return rc;
}

/* ---------------- whole audio packet decode ------------------------
 * One call per packet: mode/window flags, per-channel floor curves,
 * per-submap residues, square-polar coupling, floor-curve multiply.
 * Mirrors the staging loop of formats/vorbis.py _decode_stream_packets
 * (including its partial-packet EndOfPacket semantics: decode stops at
 * EOP and whatever was produced so far is staged).
 *
 * Layouts:
 *  mode_cfg  int32 [nmodes][2]: blockflag, mapping index
 *  map_meta  int32 [nmaps][5]: submaps, ncoupling, mux_off, submap_off,
 *            coup_off (offsets into map_mux / map_submap / map_coup)
 *  map_submap int32 pairs (floor, residue) per submap
 *  map_coup   int32 pairs (mag, ang)
 *  floors: cfg/nbr/sort blobs + per-floor offsets (floor_off [nfloors][3])
 *  res_meta  int32 [nres][7]: type, begin, end, psize, classifications,
 *            classbook, books8_off
 *  info out  int32 [12]: n, blockflag, long_prev, long_next,
 *            nonzero[0..7]
 * Returns 1 = staged (specs/info filled), 0 = skip packet, -1 = needs
 * the Python path (unsupported shape). */
int64_t vorbis_packet_decode(
    const uint8_t *data, int64_t nbytes,
    int channels, int bs0, int bs1, int mode_bits,
    const int32_t *mode_cfg, int nmodes,
    const int32_t *map_meta, const int32_t *map_mux,
    const int32_t *map_submap, const int32_t *map_coup,
    const int32_t *floor_cfgs, const int32_t *floor_nbrs,
    const int32_t *floor_sorts, const int64_t *floor_off,
    const float *fromdb,
    const int32_t *res_meta, const int32_t *res_books8,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *vqs, const int64_t *vq_off, const int32_t *dims,
    float *specs, int32_t *info)
{
    vbits br;
    int mode_idx, blockflag, map_idx, n, n2;
    int long_prev = 1, long_next = 1;
    const int32_t *mm;
    int submaps, ncoup;
    const int32_t *mux, *subm, *coup;
    int nonzero[8], nz[8];
    float *curves, *work;
    int c, s, k;
    int eop_stop = 0;

    if (channels > 8) return -1;
    br.data = data;
    br.nbytes = nbytes;
    br.pos = 0;
    br.limit = nbytes * 8;
    br.eop = 0;

    if (vb_read1(&br)) return 0;            /* not an audio packet */
    mode_idx = (int)vb_read(&br, mode_bits);
    if (mode_idx >= nmodes) return 0;
    blockflag = mode_cfg[mode_idx * 2];
    map_idx = mode_cfg[mode_idx * 2 + 1];
    n = blockflag ? bs1 : bs0;
    n2 = n / 2;
    if (blockflag) {
        long_prev = vb_read1(&br);
        long_next = vb_read1(&br);
    }
    mm = map_meta + map_idx * 5;
    submaps = mm[0];
    ncoup = mm[1];
    mux = map_mux + mm[2];
    subm = map_submap + mm[3];
    coup = map_coup + mm[4];

    curves = (float *)calloc((size_t)channels * n2, sizeof(float));
    work = (float *)calloc((size_t)channels * n2, sizeof(float));
    if (!curves || !work) {
        free(curves);
        free(work);
        return -1;
    }

    for (c = 0; c < channels; c++) nonzero[c] = 0;
    for (c = 0; c < channels && !eop_stop; c++) {
        int fl = subm[mux[c] * 2 + 0];
        int64_t rc = floor_impl(
            &br,
            floor_cfgs + floor_off[fl * 3 + 0],
            floor_nbrs + floor_off[fl * 3 + 1],
            floor_sorts + floor_off[fl * 3 + 2],
            luts, lut_off, lut_w, trees, tree_off, maxlen,
            fromdb, n2, curves + (int64_t)c * n2);
        if (rc == -2) { eop_stop = 1; break; }
        nonzero[c] = (rc == 1);
    }

    for (c = 0; c < channels; c++) nz[c] = nonzero[c];
    for (k = 0; k < ncoup; k++) {
        int mag = coup[k * 2], ang = coup[k * 2 + 1];
        if (nz[mag] || nz[ang]) { nz[mag] = 1; nz[ang] = 1; }
    }

    for (s = 0; s < submaps && !eop_stop; s++) {
        int ch_in[8], nch = 0;
        uint8_t dnd[8];
        const int32_t *rm;
        int rtype;
        int64_t begin, end, total;
        float *rwork;
        for (c = 0; c < channels; c++)
            if (mux[c] == s) {
                dnd[nch] = (uint8_t)(!nz[c]);
                ch_in[nch++] = c;
            }
        if (!nch) continue;
        rm = res_meta + subm[s * 2 + 1] * 7;
        rtype = rm[0];
        total = rtype == 2 ? (int64_t)n2 * nch : n2;
        begin = rm[1] < total ? rm[1] : total;
        end = rm[2] < total ? rm[2] : total;
        if (end <= begin) continue;
        {
            int alldnd = 1;
            for (k = 0; k < nch; k++) if (!dnd[k]) alldnd = 0;
            if (rtype == 2 && alldnd) continue;
        }
        /* rtype 2 codes one interleaved vector; reuse `work` rows for
           rtype 0/1, a scratch then deinterleave for rtype 2 */
        if (rtype == 2) {
            float *scratch = (float *)calloc((size_t)n2 * nch,
                                             sizeof(float));
            int64_t j;
            if (!scratch) { eop_stop = 1; break; }
            residue_impl(&br, luts, lut_off, lut_w, trees, tree_off,
                         maxlen, vqs, vq_off, dims, rtype, begin, end,
                         rm[3], rm[4], rm[5], res_books8 + rm[6], dnd,
                         nch, n2, scratch);
            for (k = 0; k < nch; k++) {
                float *dst = work + (int64_t)ch_in[k] * n2;
                for (j = 0; j < n2; j++)
                    dst[j] = scratch[j * nch + k];
            }
            free(scratch);
        }
        else {
            float *rows = (float *)calloc((size_t)n2 * nch,
                                          sizeof(float));
            int64_t j;
            if (!rows) { eop_stop = 1; break; }
            residue_impl(&br, luts, lut_off, lut_w, trees, tree_off,
                         maxlen, vqs, vq_off, dims, rtype, begin, end,
                         rm[3], rm[4], rm[5], res_books8 + rm[6], dnd,
                         nch, n2, rows);
            for (k = 0; k < nch; k++) {
                float *dst = work + (int64_t)ch_in[k] * n2;
                for (j = 0; j < n2; j++) dst[j] = rows[k * n2 + j];
            }
            free(rows);
        }
        if (br.eop) eop_stop = 1;
        rwork = work;
        (void)rwork;
    }

    /* square-polar coupling, reversed order (spec 4.3.5) */
    for (k = ncoup - 1; k >= 0; k--) {
        int mag = coup[k * 2], ang = coup[k * 2 + 1];
        float *M = work + (int64_t)mag * n2;
        float *A = work + (int64_t)ang * n2;
        int64_t j;
        for (j = 0; j < n2; j++) {
            float m = M[j], a = A[j], M2, A2;
            if (m > 0) {
                if (a > 0) { M2 = m; A2 = m - a; }
                else { M2 = m + a; A2 = m; }
            }
            else {
                if (a > 0) { M2 = m; A2 = m + a; }
                else { M2 = m - a; A2 = m; }
            }
            M[j] = M2;
            A[j] = A2;
        }
    }

    for (c = 0; c < channels; c++) {
        float *dst = specs + (int64_t)c * n2;
        int64_t j;
        if (nonzero[c]) {
            const float *cv = curves + (int64_t)c * n2;
            const float *rw = work + (int64_t)c * n2;
            for (j = 0; j < n2; j++) dst[j] = rw[j] * cv[j];
        }
        else {
            for (j = 0; j < n2; j++) dst[j] = 0.0f;
        }
    }

    info[0] = n;
    info[1] = blockflag;
    info[2] = long_prev;
    info[3] = long_next;
    for (c = 0; c < 8; c++) info[4 + c] = c < channels ? nonzero[c] : 0;
    free(curves);
    free(work);
    return 1;
}

/* Whole-stream audio decode: vorbis_packet_decode over every packet in
 * one call.  Packets arrive concatenated (poff/plen per packet);
 * outputs pack compactly: specs_out receives each staged packet's
 * [channels x n2] block back to back, info_out 12 int32s per staged
 * packet (same layout as vorbis_packet_decode).  Returns the number of
 * STAGED packets, or -1 when a packet needs the Python path (the
 * caller falls back for the whole stream). */
int64_t vorbis_stream_decode(
    const uint8_t *payload, const int64_t *poff, const int64_t *plen,
    int64_t n_packets,
    int channels, int bs0, int bs1, int mode_bits,
    const int32_t *mode_cfg, int nmodes,
    const int32_t *map_meta, const int32_t *map_mux,
    const int32_t *map_submap, const int32_t *map_coup,
    const int32_t *floor_cfgs, const int32_t *floor_nbrs,
    const int32_t *floor_sorts, const int64_t *floor_off,
    const float *fromdb,
    const int32_t *res_meta, const int32_t *res_books8,
    const int32_t *luts, const int64_t *lut_off, const int32_t *lut_w,
    const int32_t *trees, const int64_t *tree_off, const int32_t *maxlen,
    const float *vqs, const int64_t *vq_off, const int32_t *dims,
    int64_t specs_cap, float *specs_out, int32_t *info_out)
{
    int64_t p, staged = 0, spec_pos = 0;
    for (p = 0; p < n_packets; p++) {
        int32_t *info = info_out + staged * 12;
        int64_t rc;
        if (plen[p] == 0) continue;     /* python path skips empties */
        if (spec_pos + (int64_t)channels * (bs1 / 2) > specs_cap)
            return -1;
        rc = vorbis_packet_decode(
            payload + poff[p], plen[p],
            channels, bs0, bs1, mode_bits, mode_cfg, nmodes,
            map_meta, map_mux, map_submap, map_coup,
            floor_cfgs, floor_nbrs, floor_sorts, floor_off, fromdb,
            res_meta, res_books8,
            luts, lut_off, lut_w, trees, tree_off, maxlen,
            vqs, vq_off, dims,
            specs_out + spec_pos, info);
        if (rc == -1) return -1;
        if (rc == 0) continue;
        spec_pos += (int64_t)channels * (info[0] / 2);
        staged++;
    }
    return staged;
}
