// Host-side hot loops for the kalign ingest path (ctypes ABI).
//
// Reads are copied to the device 2-bit packed; numpy's
// strided uint8 packing of a [B, L] code matrix measured ~40 ms per 100K
// reads (1 GB/s) — this memory-bound C loop does it at DRAM rate.
//
// Reference analog: the 2-bit packed CSeqTrans representation used
// throughout libkit4b (libkit4b/SeqTrans.cpp) — here it doubles as the
// wire format to the device.
#include <cstdint>
#include <cstring>

extern "C" {

// codes [B, L] row-major (values 0..7; >=4 means non-ACGT) ->
//   packed [B, ceil(L/4)] (2-bit, codes & 3)
//   nlist  [n_cap, 2] (read_idx, base_idx) of codes >= 4, pad = 2^30
// returns number of Ns found, or -1 if more than n_cap (caller falls back).
int64_t pack2bit_u8(const uint8_t* codes, int64_t B, int64_t L,
                    uint8_t* packed, int32_t* nlist, int64_t n_cap) {
    const int64_t L4 = (L + 3) / 4;
    int64_t nn = 0;
    for (int64_t r = 0; r < B; ++r) {
        const uint8_t* row = codes + r * L;
        uint8_t* out = packed + r * L4;
        int64_t i = 0;
        for (; i + 4 <= L; i += 4) {
            uint8_t c0 = row[i], c1 = row[i + 1], c2 = row[i + 2],
                    c3 = row[i + 3];
            out[i >> 2] = (uint8_t)((c0 & 3) | ((c1 & 3) << 2)
                                    | ((c2 & 3) << 4) | ((c3 & 3) << 6));
            // non-ACGT detection without a second pass
            if ((c0 | c1 | c2 | c3) >= 4) {
                for (int64_t j = i; j < i + 4; ++j) {
                    if (row[j] >= 4) {
                        if (nn >= n_cap) return -1;
                        nlist[2 * nn] = (int32_t)r;
                        nlist[2 * nn + 1] = (int32_t)j;
                        ++nn;
                    }
                }
            }
        }
        if (i < L) {
            uint8_t v = 0;
            for (int64_t j = i; j < L; ++j) {
                v |= (uint8_t)((row[j] & 3) << ((j - i) * 2));
                if (row[j] >= 4) {
                    if (nn >= n_cap) return -1;
                    nlist[2 * nn] = (int32_t)r;
                    nlist[2 * nn + 1] = (int32_t)j;
                    ++nn;
                }
            }
            out[i >> 2] = v;
        }
    }
    for (int64_t t = nn; t < n_cap; ++t) {
        nlist[2 * t] = 1 << 30;
        nlist[2 * t + 1] = 1 << 30;
    }
    return nn;
}

// ---------------------------------------------------------------------------
// Bulk SE SAM line formatter (the reference's AppendStr/AppendUInt fast
// writers, ngskit4b/KAligner.cpp:6338-6418, applied batch-wise).
//
// For each read i of N, writes one SAM line:
//   accepted (flag != 4):
//     qname\tflag\trname\tpos\tmapq\t<L>M\t*\t0\t0\tseq\tqual\tNM:i:nm\n
//   unmapped (flag == 4):
//     qname\t4\t*\t0\t0\t*\t*\t0\t0\tseq\tqual\n
// qnames and chrom names arrive concatenated with offset tables; seq/qual
// are [N, L] ASCII matrices (seq already strand-oriented).
// Returns bytes written, or -1 when the output buffer would overflow.

static inline char* put_u64(char* p, uint64_t v) {
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

int64_t format_sam_se(const char* qname_cat, const int64_t* qname_ofs,
                      const char* chrom_cat, const int64_t* chrom_ofs,
                      const int32_t* flag, const int32_t* chrom_idx,
                      const int64_t* pos1, const int32_t* mapq,
                      const int32_t* nm,
                      const uint8_t* seq, const uint8_t* qual,
                      int64_t N, int64_t L, char* out, int64_t cap) {
    char* p = out;
    char* end = out + cap - 1;
    for (int64_t i = 0; i < N; ++i) {
        // worst case: qname + 2*L + the record's actual chrom name
        // + ~80 digits/tabs
        int64_t qlen = qname_ofs[i + 1] - qname_ofs[i];
        int64_t clen_r = (flag[i] != 4 && chrom_idx[i] >= 0)
            ? chrom_ofs[chrom_idx[i] + 1] - chrom_ofs[chrom_idx[i]] : 1;
        if (p + qlen + clen_r + 2 * L + 128 > end) return -1;
        memcpy(p, qname_cat + qname_ofs[i], (size_t)qlen); p += qlen;
        *p++ = '\t';
        if (flag[i] == 4) {
            memcpy(p, "4\t*\t0\t0\t*\t*\t0\t0\t", 16); p += 16;
        } else {
            p = put_u64(p, (uint64_t)flag[i]); *p++ = '\t';
            int64_t c = chrom_idx[i];
            int64_t clen = chrom_ofs[c + 1] - chrom_ofs[c];
            memcpy(p, chrom_cat + chrom_ofs[c], (size_t)clen); p += clen;
            *p++ = '\t';
            p = put_u64(p, (uint64_t)pos1[i]); *p++ = '\t';
            p = put_u64(p, (uint64_t)mapq[i]); *p++ = '\t';
            p = put_u64(p, (uint64_t)L); *p++ = 'M'; *p++ = '\t';
            memcpy(p, "*\t0\t0\t", 6); p += 6;
        }
        memcpy(p, seq + i * L, (size_t)L); p += L;
        *p++ = '\t';
        if (qual[i * L] == 0) {        // 0 sentinel: no quality -> "*"
            *p++ = '*';
        } else {
            memcpy(p, qual + i * L, (size_t)L); p += L;
        }
        if (flag[i] != 4) {
            memcpy(p, "\tNM:i:", 6); p += 6;
            p = put_u64(p, (uint64_t)nm[i]);
        }
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

// Paired-end bulk SAM formatter (the PE analog of format_sam_se, used by
// align/pe.py write_sam_fast): one record per array row with full mate
// fields. Conventions:
//   chrom_idx[i] <  0  -> unmapped record: "*\t0\t0\t*" for rname..cigar
//   rnext[i]     == -1 -> "=" (mate on same chrom); == -2 -> "*";
//                  else chromosome index
//   tlen[i] signed; nm[i] < 0 omits the NM tag
int64_t format_sam_pe(const char* qname_cat, const int64_t* qname_ofs,
                      const char* chrom_cat, const int64_t* chrom_ofs,
                      const int32_t* flag, const int32_t* chrom_idx,
                      const int64_t* pos1, const int32_t* mapq,
                      const int32_t* rnext, const int64_t* pnext,
                      const int64_t* tlen, const int32_t* nm,
                      const uint8_t* seq, const uint8_t* qual,
                      int64_t N, int64_t L, char* out, int64_t cap) {
    char* p = out;
    char* end = out + cap - 1;
    for (int64_t i = 0; i < N; ++i) {
        int64_t qlen = qname_ofs[i + 1] - qname_ofs[i];
        // bound with the record's ACTUAL chromosome-name lengths (RNAME
        // and RNEXT can each be long draft-assembly contig names; a fixed
        // reservation would pass the check yet overrun the buffer)
        int64_t clen_r = chrom_idx[i] >= 0
            ? chrom_ofs[chrom_idx[i] + 1] - chrom_ofs[chrom_idx[i]] : 1;
        int64_t clen_n = rnext[i] >= 0
            ? chrom_ofs[rnext[i] + 1] - chrom_ofs[rnext[i]] : 1;
        if (p + qlen + clen_r + clen_n + 2 * L + 128 > end) return -1;
        memcpy(p, qname_cat + qname_ofs[i], (size_t)qlen); p += qlen;
        *p++ = '\t';
        p = put_u64(p, (uint64_t)flag[i]); *p++ = '\t';
        if (chrom_idx[i] < 0) {
            memcpy(p, "*\t0\t0\t*\t", 8); p += 8;
        } else {
            int64_t c = chrom_idx[i];
            int64_t clen = chrom_ofs[c + 1] - chrom_ofs[c];
            memcpy(p, chrom_cat + chrom_ofs[c], (size_t)clen); p += clen;
            *p++ = '\t';
            p = put_u64(p, (uint64_t)pos1[i]); *p++ = '\t';
            p = put_u64(p, (uint64_t)mapq[i]); *p++ = '\t';
            p = put_u64(p, (uint64_t)L); *p++ = 'M'; *p++ = '\t';
        }
        if (rnext[i] == -1) {
            *p++ = '='; *p++ = '\t';
        } else if (rnext[i] == -2) {
            *p++ = '*'; *p++ = '\t';
        } else {
            int64_t c = rnext[i];
            int64_t clen = chrom_ofs[c + 1] - chrom_ofs[c];
            memcpy(p, chrom_cat + chrom_ofs[c], (size_t)clen); p += clen;
            *p++ = '\t';
        }
        p = put_u64(p, (uint64_t)pnext[i]); *p++ = '\t';
        if (tlen[i] < 0) { *p++ = '-'; p = put_u64(p, (uint64_t)(-tlen[i])); }
        else             { p = put_u64(p, (uint64_t)tlen[i]); }
        *p++ = '\t';
        memcpy(p, seq + i * L, (size_t)L); p += L;
        *p++ = '\t';
        if (qual[i * L] == 0) {
            *p++ = '*';
        } else {
            memcpy(p, qual + i * L, (size_t)L); p += L;
        }
        if (nm[i] >= 0) {
            memcpy(p, "\tNM:i:", 6); p += 6;
            p = put_u64(p, (uint64_t)nm[i]);
        }
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

// Counting-sort k-mer bucket index (SfxIndex.build_buckets fast path).
//
// seq: uint8 base codes [n] (>= 4 means non-ACGT: N / EOS / EOG);
// sa_out: caller-allocated int32 [n - k + 1]; lut_out: int64 [4^k + 1].
// Fills sa_out[0..ngood) with clean k-mer start positions grouped by
// 2-bit big-endian key, in-bucket order ascending by position (exactly
// the order numpy's stable argsort-by-key produces), and lut_out with
// the bucket boundary prefix sums. Returns ngood, or -1 on bad args.
//
// Replaces ~14 s of numpy (rolling-key build + radix argsort + bincount
// + cumsum) with ~2 s of streaming passes at 30 Mbp / k=13: histogram
// over a rolling key, exclusive prefix sum, scatter using lut_out as
// the per-bucket cursor, then one memmove to restore the boundaries.
// Reference analog: the bucket phase of CSfxArray::QSortSeq
// (libkit4b/SfxArray.cpp:9739) — the in-bucket lexicographic refinement
// is never read by bucket-probing workloads, so it is not computed.
int64_t bucket_index(const uint8_t* seq, int64_t n, int64_t k,
                     int32_t* sa_out, int64_t* lut_out) {
    if (k < 1 || k > 15 || n < k || n >= (1LL << 31)) return -1;
    const int64_t nk = 1LL << (2 * k);
    const uint32_t mask = (uint32_t)(nk - 1);
    memset(lut_out, 0, (size_t)(nk + 1) * sizeof(int64_t));
    int64_t* counts = lut_out + 1;          // counts[key] during pass 1
    uint32_t key = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t c = seq[i];
        if (c >= 4) last_bad = i;
        key = ((key << 2) | (uint32_t)(c & 3)) & mask;
        const int64_t pos = i - k + 1;
        if (pos >= 0 && last_bad < pos) counts[key]++;
    }
    // counts sit at lut_out[j+1]; an inclusive in-place cumsum turns the
    // array into bucket starts: lut_out[j] = sum of counts of buckets < j
    for (int64_t j = 1; j <= nk; ++j) lut_out[j] += lut_out[j - 1];
    const int64_t ngood = lut_out[nk];
    // scatter; lut_out[key] doubles as the bucket cursor (ends at the
    // bucket end == next bucket's start, zero-count buckets untouched)
    key = 0;
    last_bad = -1;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t c = seq[i];
        if (c >= 4) last_bad = i;
        key = ((key << 2) | (uint32_t)(c & 3)) & mask;
        const int64_t pos = i - k + 1;
        if (pos >= 0 && last_bad < pos) sa_out[lut_out[key]++] = (int32_t)pos;
    }
    memmove(lut_out + 1, lut_out, (size_t)nk * sizeof(int64_t));
    lut_out[0] = 0;
    return ngood;
}

}  // extern "C"
