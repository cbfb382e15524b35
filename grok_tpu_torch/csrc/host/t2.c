/* Tier-2 packet-header parser and emitter (ISO/IEC 15444-1 B.10).
 *
 * The port's copy of grok_tpu/native/t2.c, the only Tier-2 packet coder
 * of the port (the JAX package also keeps a Python one).
 *
 * Parses a whole tile's packet sequence in one call: inclusion and
 * zero-bitplane tag trees, numpasses code, Lblock comma code, and the
 * codeword-segment length distribution, producing a flat chunk table the
 * Python layer turns back into per-block state.  Mirrors
 * grok_tpu/t2/packet.py PrecinctCtx.decode_packet byte-for-byte; any
 * deviation (truncation, marker mismatch, capacity) returns nonzero and
 * the port's serving decode refuses the stream.
 *
 * Scope: in-stream headers only (no PPM/PPT — Python handles those).
 * Reference parity: [grok: src/lib/core/t2/T2Decompress.cpp,
 * PacketParser, TagTree] — behavior normative per B.10.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- bit reader with 0xFF stuffing (mirrors codestream/bitio.py) ---- */
typedef struct {
    const uint8_t *d;
    int pos, end;
    int cur, nbits, prev;
} br_t;

static void br_init(br_t *b, const uint8_t *d, int pos, int end) {
    b->d = d; b->pos = pos; b->end = end;
    b->cur = 0; b->nbits = 0; b->prev = 0;
}

static int br_bit(br_t *b) {
    if (b->nbits == 0) {
        if (b->pos >= b->end) return -1;
        b->nbits = (b->prev == 0xFF) ? 7 : 8;
        b->cur = b->d[b->pos];
        b->prev = b->cur;
        b->pos++;
    }
    b->nbits--;
    return (b->cur >> b->nbits) & 1;
}

static int br_bits(br_t *b, int n, int *out) {
    int v = 0;
    for (int i = 0; i < n; i++) {
        int t = br_bit(b);
        if (t < 0) return -1;
        v = (v << 1) | t;
    }
    *out = v;
    return 0;
}

static void br_align(br_t *b) {
    b->nbits = 0;
    if (b->prev == 0xFF) {
        if (b->pos < b->end) { b->prev = b->d[b->pos]; b->pos++; }
        else b->prev = 0;
    }
}

/* ---- tag tree (B.10.2; mirrors t2/tagtree.py) ---- */
#define TT_INF 0x7FFFFFFF
#define TT_MAXLEV 32

typedef struct {
    int nlev;
    int lvl_w[TT_MAXLEV];
    int lvl_off[TT_MAXLEV];
    int *value, *low;     /* arena slices */
} tt_t;

static int tt_nodes(int w, int h, tt_t *t) {
    int n = 0, lv = 0;
    while (1) {
        t->lvl_w[lv] = w;
        t->lvl_off[lv] = n;
        n += w * h;
        lv++;
        if (w == 1 && h == 1) break;
        w = (w + 1) / 2;
        h = (h + 1) / 2;
    }
    t->nlev = lv;
    return n;
}

static void tt_reset(tt_t *t, int nodes) {
    for (int i = 0; i < nodes; i++) { t->value[i] = TT_INF; t->low[i] = 0; }
}

/* returns -1 on EOF, else 1 if leaf value < threshold */
static int tt_decode(tt_t *t, br_t *br, int x, int y, int threshold) {
    int idxs[TT_MAXLEV];
    int xx = x, yy = y;
    for (int l = 0; l < t->nlev; l++) {
        idxs[l] = t->lvl_off[l] + yy * t->lvl_w[l] + xx;
        xx >>= 1; yy >>= 1;
    }
    int low = 0;
    for (int l = t->nlev - 1; l >= 0; l--) {
        int id = idxs[l];
        if (low > t->low[id]) t->low[id] = low; else low = t->low[id];
        while (low < threshold && low < t->value[id]) {
            int b = br_bit(br);
            if (b < 0) return -1;
            if (b) { t->value[id] = low; break; }
            low++;
        }
        t->low[id] = low;
    }
    return t->value[idxs[0]] < threshold;
}

/* ---- numpasses (B.10.6) ---- */
static int read_numpasses(br_t *br) {
    int b = br_bit(br); if (b < 0) return -1;
    if (!b) return 1;
    b = br_bit(br); if (b < 0) return -1;
    if (!b) return 2;
    int v;
    if (br_bits(br, 2, &v) < 0) return -1;
    if (v < 3) return 3 + v;
    if (br_bits(br, 5, &v) < 0) return -1;
    if (v < 31) return 6 + v;
    if (br_bits(br, 7, &v) < 0) return -1;
    return 37 + v;
}

static int max_seg_passes(int style, int segno) {
    if (style & 0x40) return 1;              /* HT */
    if (style & 0x04) return 1;              /* TERMALL */
    if (style & 0x01) {                      /* BYPASS */
        if (segno == 0) return 10;
        return (segno % 2) ? 2 : 1;
    }
    return 109;
}

static int floorlog2(int x) { return 31 - __builtin_clz((unsigned)x); }

/* per-block parse state */
typedef struct {
    uint8_t included;
    int zb, numpasses, lblock;
    int nsegs, cur_seg_passes;
} blk_t;

/* chunk record: 6 ints */
enum { CH_BLK, CH_LAYER, CH_SEGNO, CH_NP, CH_OFF, CH_LEN, CH_N };

/* Returns 0 on success; >0 on any condition requiring the Python parser.
 * out_counts: [0]=n_chunks, [1]=final body position. */
int grk_t2_parse(const uint8_t *body, int blen,
                 int n_ctx, const int *ctx_style, const int *ctx_band_start,
                 const int *band_ttw, const int *band_tth,
                 const int *band_blk_start,
                 const int *blk_x, const int *blk_y,
                 int n_pkts, const int *pkt_ctx, const int *pkt_layer,
                 int sop, int eph,
                 int *blk_included, int *blk_zb, int *blk_numpasses,
                 int *chunks, int chunk_cap, int *out_counts)
{
    int n_bands = ctx_band_start[n_ctx];
    int n_blks = band_blk_start[n_bands];
    int rc = 1;

    tt_t *incl = (tt_t *)calloc((size_t)n_bands * 2, sizeof(tt_t));
    if (!incl) return 2;
    tt_t *imsb = incl + n_bands;
    long total_nodes = 0;
    for (int b = 0; b < n_bands; b++) {
        if (band_ttw[b] > 0 && band_tth[b] > 0) {
            total_nodes += tt_nodes(band_ttw[b], band_tth[b], &incl[b]);
            total_nodes += tt_nodes(band_ttw[b], band_tth[b], &imsb[b]);
        }
    }
    int *arena = (int *)malloc((size_t)total_nodes * 2 * sizeof(int));
    blk_t *blks = (blk_t *)calloc((size_t)(n_blks > 0 ? n_blks : 1),
                                  sizeof(blk_t));
    if (!arena || !blks) { rc = 2; goto done; }
    {
        long off = 0;
        for (int b = 0; b < n_bands; b++) {
            if (band_ttw[b] <= 0 || band_tth[b] <= 0) continue;
            int ni = incl[b].lvl_off[incl[b].nlev - 1] + 1;
            incl[b].value = arena + off; incl[b].low = arena + off + ni;
            off += 2L * ni;
            tt_reset(&incl[b], ni);
            int nm = imsb[b].lvl_off[imsb[b].nlev - 1] + 1;
            imsb[b].value = arena + off; imsb[b].low = arena + off + nm;
            off += 2L * nm;
            tt_reset(&imsb[b], nm);
        }
    }
    for (int i = 0; i < n_blks; i++) blks[i].lblock = 3;

    int pos = 0, n_chunks = 0;

    for (int pk = 0; pk < n_pkts; pk++) {
        int ctx = pkt_ctx[pk];
        int layer = pkt_layer[pk];
        int style = ctx_style[ctx];
        if (sop) {
            if (pos + 6 > blen || body[pos] != 0xFF || body[pos + 1] != 0x91)
                goto done;
            int nsop = (body[pos + 4] << 8) | body[pos + 5];
            if (nsop != (pk % 65536)) goto done;
            pos += 6;
        }
        br_t br;
        br_init(&br, body, pos, blen);
        int bit = br_bit(&br);
        if (bit < 0) goto done;
        int body_len = 0;
        int chunk0 = n_chunks;
        if (bit) {
            for (int b = ctx_band_start[ctx]; b < ctx_band_start[ctx + 1];
                 b++) {
                for (int cb = band_blk_start[b]; cb < band_blk_start[b + 1];
                     cb++) {
                    blk_t *st = &blks[cb];
                    int x = blk_x[cb], y = blk_y[cb];
                    int included_now;
                    if (!st->included) {
                        included_now = tt_decode(&incl[b], &br, x, y,
                                                 layer + 1);
                        if (included_now < 0) goto done;
                    } else {
                        included_now = br_bit(&br);
                        if (included_now < 0) goto done;
                    }
                    if (!included_now) continue;
                    if (!st->included) {
                        int k = 1, r;
                        while ((r = tt_decode(&imsb[b], &br, x, y, k)) == 0)
                            k++;
                        if (r < 0) goto done;
                        st->zb = imsb[b].value[y * imsb[b].lvl_w[0] + x];
                        st->included = 1;
                    }
                    int newpasses = read_numpasses(&br);
                    if (newpasses < 0) goto done;
                    while ((bit = br_bit(&br)) == 1) st->lblock++;
                    if (bit < 0) goto done;
                    int remaining = newpasses;
                    while (remaining > 0) {
                        if (st->nsegs == 0) {
                            st->nsegs = 1;
                            st->cur_seg_passes = 0;
                        }
                        int segno = st->nsegs - 1;
                        int cap = max_seg_passes(style, segno) -
                            st->cur_seg_passes;
                        if (cap <= 0) {
                            st->nsegs++;
                            st->cur_seg_passes = 0;
                            continue;
                        }
                        int k = remaining < cap ? remaining : cap;
                        int seg_len;
                        if (br_bits(&br, st->lblock + floorlog2(k),
                                    &seg_len) < 0)
                            goto done;
                        st->cur_seg_passes += k;
                        if (n_chunks >= chunk_cap) { rc = 3; goto done; }
                        int *ch = chunks + (long)n_chunks * CH_N;
                        ch[CH_BLK] = cb;
                        ch[CH_LAYER] = layer;
                        ch[CH_SEGNO] = st->nsegs - 1;
                        ch[CH_NP] = k;
                        ch[CH_OFF] = body_len;   /* relative; fixed below */
                        ch[CH_LEN] = seg_len;
                        n_chunks++;
                        body_len += seg_len;
                        remaining -= k;
                    }
                    st->numpasses += newpasses;
                }
            }
        }
        br_align(&br);
        int hdr_end = br.pos;
        if (eph) {
            if (hdr_end + 2 > blen || body[hdr_end] != 0xFF ||
                body[hdr_end + 1] != 0x92)
                goto done;
            hdr_end += 2;
        }
        for (int c = chunk0; c < n_chunks; c++)
            chunks[(long)c * CH_N + CH_OFF] += hdr_end;
        pos = hdr_end + body_len;
        if (pos > blen) goto done;
    }

    for (int i = 0; i < n_blks; i++) {
        blk_included[i] = blks[i].included;
        blk_zb[i] = blks[i].zb;
        blk_numpasses[i] = blks[i].numpasses;
    }
    out_counts[0] = n_chunks;
    out_counts[1] = pos;
    rc = 0;
done:
    free(blks);
    free(arena);
    free(incl);
    return rc;
}

/* ---- Tier-2 packet EMITTER (B.10) ----------------------------------------
 * Encode side of the parser above: one call emits a whole tile's packet
 * sequence (inclusion/zero-bitplane tag trees, numpasses code, Lblock
 * comma code, segment lengths, SOP/EPH, bodies) into one output buffer.
 * Mirrors t2/packet.py PrecinctCtx.encode_packet byte-for-byte; any
 * capacity problem returns nonzero and the caller uses the Python
 * emitter.  [grok: src/lib/core/t2/T2Compress.cpp :: compressPackets] */

/* bit writer with 0xFF stuffing (mirrors codestream/bitio.BitWriter) */
typedef struct { uint8_t *out; long long n, cap; int cur, nbits; } bwr_t;

static void bw_init(bwr_t *b, uint8_t *out, long long cap) {
    b->out = out; b->n = 0; b->cap = cap; b->cur = 0; b->nbits = 0;
}

static int bw_bit(bwr_t *b, int bit) {
    int limit = (b->n > 0 && b->out[b->n - 1] == 0xFF) ? 7 : 8;
    b->cur = (b->cur << 1) | (bit & 1);
    b->nbits++;
    if (b->nbits == limit) {
        if (b->n >= b->cap) return -1;
        b->out[b->n++] = (uint8_t)b->cur;
        b->cur = 0; b->nbits = 0;
    }
    return 0;
}

static int bw_bits(bwr_t *b, int v, int nb) {
    for (int k = nb - 1; k >= 0; k--)
        if (bw_bit(b, (v >> k) & 1)) return -1;
    return 0;
}

static int bw_flush(bwr_t *b) {
    if (b->nbits) {
        int limit = (b->n > 0 && b->out[b->n - 1] == 0xFF) ? 7 : 8;
        if (b->n >= b->cap) return -1;
        b->out[b->n++] = (uint8_t)(b->cur << (limit - b->nbits));
        b->cur = 0; b->nbits = 0;
    }
    if (b->n > 0 && b->out[b->n - 1] == 0xFF) {
        if (b->n >= b->cap) return -1;
        b->out[b->n++] = 0;
    }
    return 0;
}

/* tag tree with encoder state (value/low/known) */
typedef struct {
    int nlev;
    int lvl_w[TT_MAXLEV];
    int lvl_off[TT_MAXLEV];
    int *value, *low;
    uint8_t *known;
} tte_t;

static int tte_nodes(int w, int h, tte_t *t) {
    int n = 0, lv = 0;
    while (1) {
        t->lvl_w[lv] = w;
        t->lvl_off[lv] = n;
        n += w * h;
        lv++;
        if (w == 1 && h == 1) break;
        w = (w + 1) / 2;
        h = (h + 1) / 2;
    }
    t->nlev = lv;
    return n;
}

static void tte_set(tte_t *t, int x, int y, int v) {
    for (int l = 0; l < t->nlev; l++) {
        int id = t->lvl_off[l] + y * t->lvl_w[l] + x;
        if (t->value[id] <= v) break;
        t->value[id] = v;
        x >>= 1; y >>= 1;
    }
}

static int tte_encode(tte_t *t, bwr_t *bw, int x, int y, int threshold) {
    int idxs[TT_MAXLEV];
    int xx = x, yy = y;
    for (int l = 0; l < t->nlev; l++) {
        idxs[l] = t->lvl_off[l] + yy * t->lvl_w[l] + xx;
        xx >>= 1; yy >>= 1;
    }
    int low = 0;
    for (int l = t->nlev - 1; l >= 0; l--) {
        int id = idxs[l];
        if (low > t->low[id]) t->low[id] = low; else low = t->low[id];
        while (low < threshold) {
            if (low >= t->value[id]) {
                if (!t->known[id]) {
                    if (bw_bit(bw, 1)) return -1;
                    t->known[id] = 1;
                }
                break;
            }
            if (bw_bit(bw, 0)) return -1;
            low++;
        }
        t->low[id] = low;
    }
    return 0;
}

static int bw_numpasses(bwr_t *bw, int n) {
    if (n == 1) return bw_bit(bw, 0);
    if (n == 2) return bw_bits(bw, 2, 2);
    if (n <= 5) { if (bw_bits(bw, 3, 2)) return -1;
                  return bw_bits(bw, n - 3, 2); }
    if (n <= 36) { if (bw_bits(bw, 0xF, 4)) return -1;
                   return bw_bits(bw, n - 6, 5); }
    if (n <= 164) { if (bw_bits(bw, 0x1FF, 9)) return -1;
                    return bw_bits(bw, n - 37, 7); }
    return -1;
}

static int bitlen_i(int x) { return x <= 0 ? 0 : 32 - __builtin_clz(x); }

/* per-block emit state */
typedef struct { int passes_written, rate_written, lblock; } eblk_t;

/* Emit all packets of one tile.
 * Geometry arrays exactly as grk_t2_parse.  Per block (global index):
 *   blk_zb, blk_npass (total passes), blk_lc (n_blks x n_layers,
 *   cumulative passes per layer), pass_rates/pass_terms at
 *   pass_off[blk] (cumulative bytes / terminated flags per pass),
 *   data_off[blk] (byte offset of the block's codewords in enc_data).
 * Output: packets concatenated into out (cap), per-packet lengths in
 * pkt_lens.  Returns 0, or nonzero on capacity/coding error. */
int grk_t2_emit(int n_ctx, const int *ctx_band_start,
                const int *band_ttw, const int *band_tth,
                const int *band_blk_start,
                const int *blk_x, const int *blk_y,
                int n_pkts, const int *pkt_ctx, const int *pkt_layer,
                int n_layers, int sop, int eph,
                const int *blk_zb, const int *blk_lc,
                const int *pass_off, const int *pass_rates,
                const uint8_t *pass_terms,
                const long long *data_off, const uint8_t *enc_data,
                uint8_t *out, long long cap,
                int *pkt_lens)
{
    int n_bands = ctx_band_start[n_ctx];
    int n_blks = band_blk_start[n_bands];
    int rc = 1;

    tte_t *incl = (tte_t *)calloc((size_t)n_bands * 2, sizeof(tte_t));
    if (!incl) return 2;
    tte_t *imsb = incl + n_bands;
    long total_nodes = 0;
    for (int b = 0; b < n_bands; b++)
        if (band_ttw[b] > 0 && band_tth[b] > 0) {
            total_nodes += tte_nodes(band_ttw[b], band_tth[b], &incl[b]);
            total_nodes += tte_nodes(band_ttw[b], band_tth[b], &imsb[b]);
        }
    int *arena = (int *)malloc((size_t)total_nodes * 2 * sizeof(int));
    uint8_t *karena = (uint8_t *)calloc((size_t)total_nodes, 1);
    eblk_t *st = (eblk_t *)calloc((size_t)(n_blks > 0 ? n_blks : 1),
                                  sizeof(eblk_t));
    if (!arena || !karena || !st) { rc = 2; goto done; }
    for (long i = 0; i < total_nodes * 2; i++) arena[i] = 0;
    {
        long off = 0, koff = 0;
        for (int b = 0; b < n_bands; b++) {
            if (band_ttw[b] <= 0 || band_tth[b] <= 0) continue;
            int ni = incl[b].lvl_off[incl[b].nlev - 1] + 1;
            incl[b].value = arena + off; incl[b].low = arena + off + ni;
            incl[b].known = karena + koff;
            for (int i = 0; i < ni; i++) incl[b].value[i] = TT_INF;
            off += 2L * ni; koff += ni;
            int nm = imsb[b].lvl_off[imsb[b].nlev - 1] + 1;
            imsb[b].value = arena + off; imsb[b].low = arena + off + nm;
            imsb[b].known = karena + koff;
            for (int i = 0; i < nm; i++) imsb[b].value[i] = TT_INF;
            off += 2L * nm; koff += nm;
        }
    }
    /* pre-set all leaf values (the Python model does this lazily at the
     * first layer-0 packet of each precinct; doing it up front is
     * equivalent because nothing is emitted before then) */
    for (int b = 0; b < n_bands; b++) {
        if (band_ttw[b] <= 0 || band_tth[b] <= 0) continue;
        for (int cb = band_blk_start[b]; cb < band_blk_start[b + 1]; cb++) {
            int first = 1 << 20;
            for (int l = 0; l < n_layers; l++)
                if (blk_lc[(long)cb * n_layers + l] > 0) { first = l;
                                                           break; }
            tte_set(&incl[b], blk_x[cb], blk_y[cb], first);
            tte_set(&imsb[b], blk_x[cb], blk_y[cb], blk_zb[cb]);
        }
    }
    for (int i = 0; i < n_blks; i++) st[i].lblock = 3;

    long long pos = 0;
    uint8_t scratch_hdr[65536];
    for (int pk = 0; pk < n_pkts; pk++) {
        int ctx = pkt_ctx[pk];
        int layer = pkt_layer[pk];
        bwr_t bw; bw_init(&bw, scratch_hdr, sizeof(scratch_hdr));
        if (bw_bit(&bw, 1)) goto done;
        /* first pass: header bits; remember body spans */
        long long body_len = 0;
        for (int b = ctx_band_start[ctx]; b < ctx_band_start[ctx + 1]; b++) {
            for (int cb = band_blk_start[b]; cb < band_blk_start[b + 1];
                 cb++) {
                eblk_t *s = &st[cb];
                int total = blk_lc[(long)cb * n_layers + layer];
                int newp = total - s->passes_written;
                if (s->passes_written == 0) {
                    if (tte_encode(&incl[b], &bw, blk_x[cb], blk_y[cb],
                                   layer + 1)) goto done;
                } else {
                    if (bw_bit(&bw, newp > 0 ? 1 : 0)) goto done;
                }
                if (newp <= 0) continue;
                if (s->passes_written == 0) {
                    if (tte_encode(&imsb[b], &bw, blk_x[cb], blk_y[cb],
                                   TT_INF)) goto done;
                }
                if (bw_numpasses(&bw, newp)) goto done;
                /* chunk by segment termination */
                const int *rates = pass_rates + pass_off[cb];
                const uint8_t *terms = pass_terms + pass_off[cb];
                int chunks_n[64], chunks_len[64], nch = 0;
                int nump = 0, prev_rate = s->rate_written;
                for (int pi = s->passes_written; pi < total; pi++) {
                    nump++;
                    if (terms[pi] || pi == total - 1) {
                        if (nch >= 64) goto done;
                        chunks_n[nch] = nump;
                        chunks_len[nch] = rates[pi] - prev_rate;
                        prev_rate = rates[pi];
                        nch++;
                        nump = 0;
                    }
                }
                int increment = 0;
                for (int c2 = 0; c2 < nch; c2++) {
                    int bits_needed = bitlen_i(chunks_len[c2]);
                    if (bits_needed < 1) bits_needed = 1;
                    int have = s->lblock + bitlen_i(chunks_n[c2]) - 1;
                    if (bits_needed - have > increment)
                        increment = bits_needed - have;
                }
                for (int k = 0; k < increment; k++)
                    if (bw_bit(&bw, 1)) goto done;
                if (bw_bit(&bw, 0)) goto done;
                s->lblock += increment;
                for (int c2 = 0; c2 < nch; c2++)
                    if (bw_bits(&bw, chunks_len[c2],
                                s->lblock + bitlen_i(chunks_n[c2]) - 1))
                        goto done;
                body_len += rates[total - 1] - s->rate_written;
                /* body copied in the second pass below */
            }
        }
        if (bw_flush(&bw)) goto done;
        long long need = (sop ? 6 : 0) + bw.n + (eph ? 2 : 0) + body_len;
        if (pos + need > cap) { rc = 3; goto done; }
        long long p0 = pos;
        if (sop) {
            out[pos++] = 0xFF; out[pos++] = 0x91;
            out[pos++] = 0; out[pos++] = 4;
            out[pos++] = (uint8_t)((pk >> 8) & 0xFF);
            out[pos++] = (uint8_t)(pk & 0xFF);
        }
        memcpy(out + pos, scratch_hdr, (size_t)bw.n);
        pos += bw.n;
        if (eph) { out[pos++] = 0xFF; out[pos++] = 0x92; }
        /* second pass: bodies + state updates */
        for (int b = ctx_band_start[ctx]; b < ctx_band_start[ctx + 1]; b++) {
            for (int cb = band_blk_start[b]; cb < band_blk_start[b + 1];
                 cb++) {
                eblk_t *s = &st[cb];
                int total = blk_lc[(long)cb * n_layers + layer];
                int newp = total - s->passes_written;
                if (newp <= 0) continue;
                const int *rates = pass_rates + pass_off[cb];
                int end = rates[total - 1];
                memcpy(out + pos, enc_data + data_off[cb] + s->rate_written,
                       (size_t)(end - s->rate_written));
                pos += end - s->rate_written;
                s->passes_written = total;
                s->rate_written = end;
            }
        }
        pkt_lens[pk] = (int)(pos - p0);
    }
    rc = 0;
done:
    free(st);
    free(karena);
    free(arena);
    free(incl);
    return rc;
}
