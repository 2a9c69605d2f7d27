// Vectorized PE output routing (reference: src/peprocessor.cpp:488-579).
//
// The reference routes each processed pair through a per-read switch into up
// to 7 output streams (out1/out2/merged/unpaired1/unpaired2/failed/stdout).
// fastp_tpu's device step returns per-pair verdict arrays; these emitters
// turn those arrays into output text in one native pass per stream instead
// of a per-row Python loop.  Two shapes cover every stream:
//
//   fq_emit_routed — per row, slot A (from read1) then slot B (from read2),
//     each skipped / windowed / raw, with an optional " tag" appended to the
//     name (used for failed-read tags, reference: src/read.cpp:119-173
//     appendToStringWithTag).  Covers out1, out2, interleaved stdout,
//     unpaired1/2 (including the r2->unpaired1 fallback), and failed.
//
//   fq_emit_merged — merge-mode "merged" stream: a merged record built as
//     r1-window[:len1] + revcomp(r2-window[:rlen2])[ol:ol+len2] with name
//     tag " merged_<len1>_<len2>" (reference: src/overlapanalysis.cpp:152-183),
//     or, for unmerged rows with --include_unmerged, the surviving mates
//     (reference: src/peprocessor.cpp:497-523).
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

const uint8_t* COMP() {
    // ACGT/acgt complemented (case folded to upper), everything else 'N'
    // (matches Sequence::reverseComplement, reference src/sequence.cpp:23-50)
    static uint8_t t[256];
    static bool init = false;
    if (!init) {
        memset(t, 'N', 256);
        t['A'] = 'T'; t['a'] = 'T'; t['T'] = 'A'; t['t'] = 'A';
        t['C'] = 'G'; t['c'] = 'G'; t['G'] = 'C'; t['g'] = 'C';
        init = true;
    }
    return t;
}

inline uint8_t* put(uint8_t* o, const uint8_t* src, int64_t n) {
    memcpy(o, src, n);
    return o + n;
}

// Chunked field copy: one 32B vector load/store per 32 bytes instead of a
// glibc memcpy dispatch per ~40-150B field.  Overcopies up to 31B past
// o+n (caller caps reserve slack; later fields overwrite it) but never
// overreads past src_end (conservative: src_end is the highest byte any
// row's field reaches, so reads stay inside the allocation).
inline uint8_t* put_n(uint8_t* o, const uint8_t* src, int64_t n,
                      const uint8_t* src_end) {
    if (src + n + 31 <= src_end) {
        for (int64_t i = 0; i < n; i += 32)
            memcpy(o + i, src + i, 32);
        return o + n;
    }
    memcpy(o, src, (size_t)n);
    return o + n;
}

inline int64_t blob_hi(const int64_t* off, const int32_t* len, int64_t B) {
    int64_t hi = 0;
    for (int64_t i = 0; i < B; i++)
        if (off[i] + len[i] > hi) hi = off[i] + len[i];
    return hi;
}

}  // namespace

extern "C" {

// One output stream; per row slot A (read1) then slot B (read2).
//   emitX: 0 = skip, 1 = window [tf, tf+rlen), 2 = raw [pre, lraw)
//   tagX: index into the tag table (name += " " + tag), or -1 for no tag
// Returns bytes written to out (caller sizes generously).
int64_t fq_emit_routed(
    const uint8_t* nb1, const int64_t* noff1, const int32_t* nlen1,
    const uint8_t* sb1, const int64_t* soff1, const int32_t* slen1,
    const uint8_t* bases1, const uint8_t* quals1,
    const int32_t* tf1, const int32_t* rlen1,
    const int32_t* pre1, const int32_t* lraw1,
    const uint8_t* nb2, const int64_t* noff2, const int32_t* nlen2,
    const uint8_t* sb2, const int64_t* soff2, const int32_t* slen2,
    const uint8_t* bases2, const uint8_t* quals2,
    const int32_t* tf2, const int32_t* rlen2,
    const int32_t* pre2, const int32_t* lraw2,
    int64_t B, int64_t W,
    const uint8_t* emitA, const int32_t* tagA,
    const uint8_t* emitB, const int32_t* tagB,
    const uint8_t* tagblob, const int64_t* tag_off, const int32_t* tag_len,
    uint8_t* out) {
    uint8_t* o = out;
    const uint8_t* nb_end[2] = {nb1 + blob_hi(noff1, nlen1, B),
                                nb2 + blob_hi(noff2, nlen2, B)};
    const uint8_t* sb_end[2] = {sb1 + blob_hi(soff1, slen1, B),
                                sb2 + blob_hi(soff2, slen2, B)};
    const uint8_t* mat_end[2] = {bases1 + B * W, bases2 + B * W};
    const uint8_t* qmat_end[2] = {quals1 + B * W, quals2 + B * W};
    for (int64_t i = 0; i < B; i++) {
        for (int slot = 0; slot < 2; slot++) {
            uint8_t em = slot == 0 ? emitA[i] : emitB[i];
            if (!em) continue;
            const uint8_t* nb = slot == 0 ? nb1 : nb2;
            const int64_t* noff = slot == 0 ? noff1 : noff2;
            const int32_t* nlen = slot == 0 ? nlen1 : nlen2;
            const uint8_t* sb = slot == 0 ? sb1 : sb2;
            const int64_t* soff = slot == 0 ? soff1 : soff2;
            const int32_t* slen = slot == 0 ? slen1 : slen2;
            const uint8_t* bases = slot == 0 ? bases1 : bases2;
            const uint8_t* quals = slot == 0 ? quals1 : quals2;
            int32_t start, len;
            if (em == 1) {
                start = (slot == 0 ? tf1 : tf2)[i];
                len = (slot == 0 ? rlen1 : rlen2)[i];
            } else {
                start = (slot == 0 ? pre1 : pre2)[i];
                len = (slot == 0 ? lraw1 : lraw2)[i] - start;
            }
            if (len < 0) len = 0;
            int32_t tg = slot == 0 ? tagA[i] : tagB[i];
            o = put_n(o, nb + noff[i], nlen[i], nb_end[slot]);
            if (tg >= 0) {
                *o++ = ' ';
                o = put(o, tagblob + tag_off[tg], tag_len[tg]);
            }
            *o++ = '\n';
            o = put_n(o, bases + i * W + start, len, mat_end[slot]);
            *o++ = '\n';
            o = put_n(o, sb + soff[i], slen[i], sb_end[slot]);
            *o++ = '\n';
            o = put_n(o, quals + i * W + start, len, qmat_end[slot]);
            *o++ = '\n';
        }
    }
    return o - out;
}

// Merge-mode "merged" stream.
//   m_emit rows: merged record with " merged_<len1>_<len2>" name tag (and
//     strand tag when the strand line is not exactly "+").
//   otherwise (include_unmerged): r1 window if umA, then r2 window if umB.
int64_t fq_emit_merged(
    const uint8_t* nb1, const int64_t* noff1, const int32_t* nlen1,
    const uint8_t* sb1, const int64_t* soff1, const int32_t* slen1,
    const uint8_t* bases1, const uint8_t* quals1,
    const int32_t* tf1, const int32_t* rlen1,
    const uint8_t* nb2, const int64_t* noff2, const int32_t* nlen2,
    const uint8_t* sb2, const int64_t* soff2, const int32_t* slen2,
    const uint8_t* bases2, const uint8_t* quals2,
    const int32_t* tf2, const int32_t* rlen2,
    int64_t B, int64_t W,
    const uint8_t* m_emit, const int32_t* m_len1, const int32_t* m_len2,
    const int32_t* m_ol,
    const uint8_t* umA, const uint8_t* umB,
    uint8_t* out) {
    const uint8_t* comp = COMP();
    uint8_t* o = out;
    char tag[48];
    for (int64_t i = 0; i < B; i++) {
        if (m_emit[i]) {
            int tl = snprintf(tag, sizeof(tag), " merged_%d_%d",
                              (int)m_len1[i], (int)m_len2[i]);
            o = put(o, nb1 + noff1[i], nlen1[i]);
            o = put(o, (const uint8_t*)tag, tl);
            *o++ = '\n';
            const uint8_t* b1 = bases1 + i * W + tf1[i];
            const uint8_t* q1 = quals1 + i * W + tf1[i];
            const uint8_t* b2 = bases2 + i * W + tf2[i];
            const uint8_t* q2 = quals2 + i * W + tf2[i];
            int l1 = m_len1[i], l2 = m_len2[i];
            int base2 = rlen2[i] - 1 - m_ol[i];
            o = put(o, b1, l1);
            for (int j = 0; j < l2; j++) *o++ = comp[b2[base2 - j]];
            *o++ = '\n';
            o = put(o, sb1 + soff1[i], slen1[i]);
            if (!(slen1[i] == 1 && sb1[soff1[i]] == '+'))
                o = put(o, (const uint8_t*)tag, tl);
            *o++ = '\n';
            o = put(o, q1, l1);
            for (int j = 0; j < l2; j++) *o++ = q2[base2 - j];
            *o++ = '\n';
        } else {
            if (umA && umA[i]) {
                o = put(o, nb1 + noff1[i], nlen1[i]);
                *o++ = '\n';
                o = put(o, bases1 + i * W + tf1[i], rlen1[i]);
                *o++ = '\n';
                o = put(o, sb1 + soff1[i], slen1[i]);
                *o++ = '\n';
                o = put(o, quals1 + i * W + tf1[i], rlen1[i]);
                *o++ = '\n';
            }
            if (umB && umB[i]) {
                o = put(o, nb2 + noff2[i], nlen2[i]);
                *o++ = '\n';
                o = put(o, bases2 + i * W + tf2[i], rlen2[i]);
                *o++ = '\n';
                o = put(o, sb2 + soff2[i], slen2[i]);
                *o++ = '\n';
                o = put(o, quals2 + i * W + tf2[i], rlen2[i]);
                *o++ = '\n';
            }
        }
    }
    return o - out;
}

// --- gzip INPUT ------------------------------------------------------------
// Throughput-grade streaming inflate (reference: the igzip reader loop in
// src/fastqreader.cpp:79-140).  Whole members decompress through libdeflate
// (~2-3x zlib) with multi-member restart; a member that does not fit the
// supplied buffers (a giant single-member file) streams through zlib
// instead, so arbitrary gzip files work with bounded memory.

struct GzReader {
    z_stream zs;
    bool z_init = false;    // inflateInit2 done
    bool z_active = false;  // currently streaming a member through zlib
#ifdef HAVE_LIBDEFLATE
    struct libdeflate_decompressor* d = nullptr;
#endif
};

extern "C" void* gz_reader_create() {
    GzReader* g = new GzReader();
    memset(&g->zs, 0, sizeof(g->zs));
#ifdef HAVE_LIBDEFLATE
    g->d = libdeflate_alloc_decompressor();
#endif
    return g;
}

extern "C" void gz_reader_destroy(void* h) {
    GzReader* g = (GzReader*)h;
    if (g->z_init) inflateEnd(&g->zs);
#ifdef HAVE_LIBDEFLATE
    if (g->d) libdeflate_free_decompressor(g->d);
#endif
    delete g;
}

static bool gz_activate_zlib(GzReader* g) {
    if (!g->z_init) {
        memset(&g->zs, 0, sizeof(g->zs));
        if (inflateInit2(&g->zs, 16 + 15) != Z_OK) return false;
        g->z_init = true;
    } else if (inflateReset2(&g->zs, 16 + 15) != Z_OK) {
        return false;
    }
    g->z_active = true;
    return true;
}

// Inflate from in[0..in_len) into out[0..out_cap).  is_final: no more
// compressed bytes will ever arrive.  Returns bytes written (>= 0) and
// fills *in_consumed; -1 = corrupt stream, -2 = the buffer ends inside a
// member libdeflate cannot finish and nothing was written (caller should
// append more compressed bytes and retry).
extern "C" int64_t gz_reader_inflate(void* h, const uint8_t* in,
                                     int64_t in_len, int is_final,
                                     uint8_t* out, int64_t out_cap,
                                     int64_t* in_consumed) {
    GzReader* g = (GzReader*)h;
    int64_t ic = 0, ow = 0;
    while (ow < out_cap && (ic < in_len || (g->z_active && is_final))) {
        if (g->z_active) {
            g->zs.next_in = (Bytef*)(in + ic);
            g->zs.avail_in = (uInt)std::min<int64_t>(in_len - ic, 1 << 30);
            g->zs.next_out = out + ow;
            g->zs.avail_out = (uInt)std::min<int64_t>(out_cap - ow, 1 << 30);
            uInt before_in = g->zs.avail_in;
            uInt before_out = g->zs.avail_out;
            int r = inflate(&g->zs, is_final ? Z_FINISH : Z_NO_FLUSH);
            ic += before_in - g->zs.avail_in;
            ow += before_out - g->zs.avail_out;
            if (r == Z_STREAM_END) {
                g->z_active = false;  // member done; boundary mode again
                continue;
            }
            if (r == Z_OK || r == Z_BUF_ERROR) {
                if (before_in == g->zs.avail_in
                        && before_out == g->zs.avail_out)
                    break;  // no progress possible: need more input/output
                continue;
            }
            *in_consumed = ic;
            return -1;
        }
        // at a member boundary
#ifdef HAVE_LIBDEFLATE
        if (g->d) {
            size_t ain = 0, aout = 0;
            enum libdeflate_result r = libdeflate_gzip_decompress_ex(
                g->d, in + ic, (size_t)(in_len - ic),
                out + ow, (size_t)(out_cap - ow), &ain, &aout);
            if (r == LIBDEFLATE_SUCCESS) {
                ic += (int64_t)ain;
                ow += (int64_t)aout;
                continue;
            }
            if (r == LIBDEFLATE_INSUFFICIENT_SPACE) {
                if (ow > 0) break;     // drain what we have, call again
                if (!gz_activate_zlib(g)) { *in_consumed = ic; return -1; }
                continue;              // giant member: stream it
            }
            // BAD_DATA: a member truncated mid-buffer, or real corruption
            if (!is_final) {
                if (ow > 0) break;     // drain, read more, retry
                *in_consumed = ic;
                return -2;             // need more compressed input
            }
            // final buffer: zlib reproduces exact error/tail semantics
            if (!gz_activate_zlib(g)) { *in_consumed = ic; return -1; }
            continue;
        }
#endif
        if (!gz_activate_zlib(g)) { *in_consumed = ic; return -1; }
    }
    *in_consumed = ic;
    return ow;
}

// Throughput-grade gzip compression via libdeflate, one whole member per
// call exactly like the reference writer (src/writer.cpp:110-133).
// Returns compressed size, 0 if the output buffer is too small, or -1 when
// built without libdeflate (caller falls back to zlib).
int64_t gzip_compress(const uint8_t* in, int64_t in_len, int level,
                      uint8_t* out, int64_t out_cap) {
#ifdef HAVE_LIBDEFLATE
    static thread_local struct libdeflate_compressor* comp = nullptr;
    static thread_local int comp_level = -1;
    if (comp == nullptr || comp_level != level) {
        if (comp) libdeflate_free_compressor(comp);
        comp = libdeflate_alloc_compressor(level);
        comp_level = level;
        if (!comp) return -1;
    }
    size_t n = libdeflate_gzip_compress(comp, in, (size_t)in_len,
                                        out, (size_t)out_cap);
    return (int64_t)n;
#else
    (void)in; (void)in_len; (void)level; (void)out; (void)out_cap;
    return -1;
#endif
}

int64_t gzip_compress_bound(int64_t in_len, int level) {
#ifdef HAVE_LIBDEFLATE
    static thread_local struct libdeflate_compressor* comp = nullptr;
    static thread_local int comp_level = -1;
    if (comp == nullptr || comp_level != level) {
        if (comp) libdeflate_free_compressor(comp);
        comp = libdeflate_alloc_compressor(level);
        comp_level = level;
        if (!comp) return -1;
    }
    return (int64_t)libdeflate_gzip_compress_bound(comp, (size_t)in_len);
#else
    (void)in_len; (void)level;
    return -1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Overrepresented-sequence scanning (reference: src/stats.cpp:312-329).
// The key set is fixed after the evaluator pre-pass, so it is indexed once
// into per-length hash maps (string_view keys over owned storage: no
// allocation on the per-position probe).

namespace {

struct OraDB {
    std::vector<std::string> storage;
    // the reference's fixed step list {10,20,40,100,min(150,evalLen-2)} --
    // duplicate lengths scan twice, as in src/stats.cpp:314
    std::vector<int> steps;
    std::unordered_map<int, std::unordered_map<std::string_view, int32_t>> by_len;
    int eval_len;
};

}  // namespace

extern "C" {

void* ora_create(const uint8_t* keys, const int64_t* koff,
                 const int32_t* klen, int64_t nkeys, int eval_len,
                 const int32_t* steps, int nsteps) {
    OraDB* db = new OraDB();
    db->eval_len = eval_len;
    db->steps.assign(steps, steps + nsteps);
    db->storage.reserve(nkeys);
    for (int64_t i = 0; i < nkeys; i++)
        db->storage.emplace_back((const char*)keys + koff[i], (size_t)klen[i]);
    for (int64_t i = 0; i < nkeys; i++) {
        int L = (int)db->storage[i].size();
        db->by_len[L].emplace(std::string_view(db->storage[i]), (int32_t)i);
    }
    return db;
}

void ora_destroy(void* h) {
    delete (OraDB*)h;
}

// Scan selected rows; counts[nkeys] and dist[nkeys * eval_len] accumulate.
// Matches the reference scan order: per step length, advance by step+1 on a
// hit, else by 1 (reference: src/stats.cpp:312-329).
void ora_stat_batch(void* h, const uint8_t* bases, int64_t W,
                    const int32_t* start, const int32_t* rlen,
                    const int32_t* rows, int64_t nrows,
                    int64_t* counts, int64_t* dist) {
    OraDB* db = (OraDB*)h;
    int eval_len = db->eval_len;
    for (int64_t r = 0; r < nrows; r++) {
        int64_t row = rows[r];
        const char* seq = (const char*)bases + row * W + start[row];
        int n = rlen[row];
        for (int step : db->steps) {
            auto mit = db->by_len.find(step);
            if (mit == db->by_len.end()) continue;
            auto& m = mit->second;
            int i = 0;
            while (i < n - step) {
                auto it = m.find(std::string_view(seq + i, step));
                if (it != m.end()) {
                    int32_t ki = it->second;
                    counts[ki]++;
                    int64_t* d = dist + (int64_t)ki * eval_len;
                    int hi = i + step < eval_len ? i + step : eval_len;
                    for (int p = i; p < hi; p++) d[p]++;
                    i += step;
                }
                i += 1;
            }
        }
    }
}

}  // extern "C"

namespace {

// reference: src/read.cpp:75-85 (Read::lastIndex)
inline void last_index(const uint8_t* name, int32_t n,
                       const uint8_t** out, int32_t* outlen) {
    *out = name;
    *outlen = 0;
    if (n < 5) return;
    for (int32_t i = n - 3; i >= 0; i--) {
        if (name[i] == ':' || name[i] == '+') {
            *out = name + i + 1;
            *outlen = n - i - 1;
            return;
        }
    }
}

// reference: src/read.cpp:87-100 (Read::firstIndex)
inline void first_index(const uint8_t* name, int32_t n,
                        const uint8_t** out, int32_t* outlen) {
    *out = name;
    *outlen = 0;
    if (n < 5) return;
    int32_t end = n;
    for (int32_t i = n - 3; i >= 0; i--) {
        if (name[i] == '+') end = i - 1;
        if (name[i] == ':') {
            *out = name + i + 1;
            int32_t l = end - i;
            if (l < 0) l = 0;
            if (i + 1 + l > n) l = n - i - 1;
            *outlen = l;
            return;
        }
    }
}

// name + tag spliced before the first space
// (reference: src/umiprocessor.cpp:63-83)
inline uint8_t* splice_umi(uint8_t* o, const uint8_t* name, int32_t nlen,
                           const uint8_t* delim, int dlen,
                           const uint8_t* prefix, int plen,
                           const uint8_t* umi, int32_t ulen,
                           const uint8_t* umi2, int32_t ulen2) {
    int32_t space = -1;
    for (int32_t i = 0; i < nlen; i++)
        if (name[i] == ' ') { space = i; break; }
    int32_t head = space < 0 ? nlen : space;
    o = put(o, name, head);
    o = put(o, delim, dlen);
    if (plen) { o = put(o, prefix, plen); *o++ = '_'; }
    o = put(o, umi, ulen);
    if (umi2) { *o++ = '_'; o = put(o, umi2, ulen2); }
    if (space >= 0) o = put(o, name + space, nlen - space);
    return o;
}

}  // namespace

extern "C" {

// Batched UMI extraction + name splicing (reference: src/umiprocessor.cpp:11-83).
// loc: 1=index1 2=index2 3=read1 4=read2 5=per_index 6=per_read.
// nb2 may be NULL for single-end.  Writes rebuilt names into out1/out2 with
// (ooff, olen) tables and per-read head pre-trims into pre1/pre2.
// Returns bytes written to out1; *out2_written gets out2's size.
int64_t umi_process(
    const uint8_t* nb1, const int64_t* noff1, const int32_t* nlen1,
    const uint8_t* nb2, const int64_t* noff2, const int32_t* nlen2,
    const uint8_t* bases1, const int32_t* len1,
    const uint8_t* bases2, const int32_t* len2,
    int64_t B, int64_t W,
    int loc, int umi_len, int skip,
    const uint8_t* prefix, int prefix_len,
    const uint8_t* delim, int delim_len,
    uint8_t* out1, int64_t* ooff1, int32_t* olen1,
    uint8_t* out2, int64_t* ooff2, int32_t* olen2,
    int32_t* pre1, int32_t* pre2, int64_t* out2_written) {
    uint8_t* o1 = out1;
    uint8_t* o2 = out2;
    bool has2 = nb2 != nullptr;
    for (int64_t i = 0; i < B; i++) {
        const uint8_t* n1 = nb1 + noff1[i];
        int32_t l1 = nlen1[i];
        const uint8_t* n2 = has2 ? nb2 + noff2[i] : nullptr;
        int32_t l2 = has2 ? nlen2[i] : 0;
        const uint8_t* umi = nullptr;
        int32_t ulen = 0;
        const uint8_t* umi2 = nullptr;
        int32_t ulen2 = 0;
        pre1[i] = 0;
        pre2[i] = 0;
        switch (loc) {
        case 1:  // index1
            first_index(n1, l1, &umi, &ulen);
            break;
        case 2:  // index2
            if (has2) last_index(n2, l2, &umi, &ulen);
            break;
        case 3: {  // read1
            int32_t sl = len1[i];
            ulen = umi_len < sl ? umi_len : sl;
            umi = bases1 + i * W;
            int32_t p = ulen + skip;
            if (p > sl - 1) p = sl - 1;
            if (p < 0) p = 0;
            pre1[i] = p;
            break;
        }
        case 4: {  // read2
            if (has2) {
                int32_t sl = len2[i];
                ulen = umi_len < sl ? umi_len : sl;
                umi = bases2 + i * W;
                int32_t p = ulen + skip;
                if (p > sl - 1) p = sl - 1;
                if (p < 0) p = 0;
                pre2[i] = p;
            }
            break;
        }
        case 5:  // per_index
            first_index(n1, l1, &umi, &ulen);
            if (has2) last_index(n2, l2, &umi2, &ulen2);
            break;
        case 6: {  // per_read
            int32_t sl = len1[i];
            ulen = umi_len < sl ? umi_len : sl;
            umi = bases1 + i * W;
            int32_t p = ulen + skip;
            if (p > sl - 1) p = sl - 1;
            if (p < 0) p = 0;
            pre1[i] = p;
            if (has2) {
                int32_t sl2 = len2[i];
                ulen2 = umi_len < sl2 ? umi_len : sl2;
                umi2 = bases2 + i * W;
                int32_t p2 = ulen2 + skip;
                if (p2 > sl2 - 1) p2 = sl2 - 1;
                if (p2 < 0) p2 = 0;
                pre2[i] = p2;
            }
            break;
        }
        }
        bool edit;
        if (loc == 5 || loc == 6)
            edit = true;  // per_* tags even when parts are empty
        else
            edit = ulen > 0;
        ooff1[i] = o1 - out1;
        if (edit)
            o1 = splice_umi(o1, n1, l1, delim, delim_len, prefix, prefix_len,
                            umi, ulen, umi2, ulen2);
        else
            o1 = put(o1, n1, l1);
        olen1[i] = (int32_t)((o1 - out1) - ooff1[i]);
        if (has2) {
            ooff2[i] = o2 - out2;
            if (edit)
                o2 = splice_umi(o2, n2, l2, delim, delim_len, prefix, prefix_len,
                                umi, ulen, umi2, ulen2);
            else
                o2 = put(o2, n2, l2);
            olen2[i] = (int32_t)((o2 - out2) - ooff2[i]);
        }
    }
    *out2_written = o2 - out2;
    return o1 - out1;
}

// Index-blacklist filtering (reference: src/filter.cpp:224-258):
// drop a pair when first_index(name1) matches blacklist1 or
// last_index(name2) matches blacklist2 within `threshold` mismatches.
// nb2 may be NULL (single-end: only blacklist1 applies).
void index_filter(
    const uint8_t* nb1, const int64_t* noff1, const int32_t* nlen1,
    const uint8_t* nb2, const int64_t* noff2, const int32_t* nlen2,
    const uint8_t* bl1, const int64_t* bl1_off, const int32_t* bl1_len,
    int32_t n_bl1,
    const uint8_t* bl2, const int64_t* bl2_off, const int32_t* bl2_len,
    int32_t n_bl2,
    int threshold, int64_t B, uint8_t* drop) {
    auto match = [&](const uint8_t* blob, const int64_t* boff,
                     const int32_t* blen, int32_t n_bl,
                     const uint8_t* idx, int32_t ilen) -> bool {
        for (int32_t k = 0; k < n_bl; k++) {
            const uint8_t* item = blob + boff[k];
            int32_t m = blen[k] < ilen ? blen[k] : ilen;
            int diff = 0;
            bool ok = true;
            for (int32_t s = 0; s < m; s++) {
                if (item[s] != idx[s]) {
                    if (++diff > threshold) { ok = false; break; }
                }
            }
            if (ok && diff <= threshold) return true;
        }
        return false;
    };
    for (int64_t i = 0; i < B; i++) {
        drop[i] = 0;
        const uint8_t* idx1;
        int32_t il1;
        first_index(nb1 + noff1[i], nlen1[i], &idx1, &il1);
        if (n_bl1 && match(bl1, bl1_off, bl1_len, n_bl1, idx1, il1)) {
            drop[i] = 1;
            continue;
        }
        if (nb2 != nullptr && n_bl2) {
            const uint8_t* idx2;
            int32_t il2;
            last_index(nb2 + noff2[i], nlen2[i], &idx2, &il2);
            if (match(bl2, bl2_off, bl2_len, n_bl2, idx2, il2))
                drop[i] = 1;
        }
    }
}

}  // extern "C"
