// Native build-pipeline kernels for kaamer-jax.
//
// The reference's build hot path is Go goroutines feeding an LSM tree
// (makedb/inputFASTA.go:245-248 + Badger compaction).  Here the database
// build is a sort pipeline over flat arrays, and these C++ kernels keep the
// host side of that pipeline at memory-bandwidth speed:
//
//   kt_extract_pairs : encode all sliding-window 7-mers of a batch of
//                      sequences into (kmer<<32 | row) uint64 pairs,
//                      multithreaded over sequences.  Exact same codec as
//                      kaamer_jax/codec.py (pair codes 22 + a*21 + b, 0 for
//                      invalid; final residue 5 bits).
//   kt_sort_u64      : parallel LSD radix sort (8x8-bit passes, per-thread
//                      histograms).
//   kt_parse_fasta   : FASTA scanner over an in-memory buffer -> concatenated
//                      uppercased sequences + headers with offsets.
//
// Built with plain g++ (no Python headers); bound via ctypes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static int8_t CHAR_CODE[256];
static bool CODE_INIT = false;

static void init_codes() {
    if (CODE_INIT) return;
    const char* alpha = "ACDEFGHIKLMNPQRSTUVWY";
    for (int i = 0; i < 256; i++) CHAR_CODE[i] = -1;
    for (int i = 0; alpha[i]; i++) CHAR_CODE[(uint8_t)alpha[i]] = (int8_t)i;
    CODE_INIT = true;
}

static inline uint32_t pair_code(int a, int b) {
    return (a >= 0 && b >= 0) ? (uint32_t)(22 + a * 21 + b) : 0u;
}

// Encode all 7-mers of sequences given as one concatenated byte buffer with
// n+1 offsets.  out must have room for sum(len_i - 6 when len_i >= 7).
// rows written are row_base + i.  Returns the number of pairs written.
int64_t kt_extract_pairs(const uint8_t* seqs, const int64_t* offsets,
                         int64_t n_seqs, int64_t row_base, uint64_t* out,
                         int n_threads) {
    init_codes();
    if (n_threads < 1) n_threads = 1;

    // per-sequence output offsets (prefix sum of kmer counts)
    std::vector<int64_t> out_off(n_seqs + 1, 0);
    for (int64_t i = 0; i < n_seqs; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        out_off[i + 1] = out_off[i] + (len >= 7 ? len - 6 : 0);
    }

    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            const uint8_t* s = seqs + offsets[i];
            int64_t len = offsets[i + 1] - offsets[i];
            if (len < 7) continue;
            uint64_t* dst = out + out_off[i];
            uint64_t row = (uint64_t)(row_base + i);
            int c[7];
            for (int64_t k = 0; k + 7 <= len; k++) {
                for (int t = 0; t < 7; t++) c[t] = CHAR_CODE[s[k + t]];
                uint32_t v = (pair_code(c[0], c[1]) << 23) |
                             (pair_code(c[2], c[3]) << 14) |
                             (pair_code(c[4], c[5]) << 5) |
                             (uint32_t)(c[6] >= 0 ? c[6] : 0);
                dst[k] = ((uint64_t)v << 32) | row;
            }
        }
    };

    if (n_threads == 1 || n_seqs < 64) {
        worker(0, n_seqs);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (n_seqs + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = std::min(n_seqs, lo + chunk);
            if (lo < hi) ts.emplace_back(worker, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    return out_off[n_seqs];
}

// Pack query sequences straight into the base-22 uint32 wire format
// (7 residues/word, MSB-first, pad code 21) -- the fused equivalent of
// codec.pad_codes_batch + codec.pack_codes7, which together are the largest
// serial host cost per dispatched batch.  out must hold
// n_seqs * ceil(width/7) words.  Returns the number of words written.
int64_t kt_pack_queries(const uint8_t* seqs, const int64_t* offsets,
                        int64_t n_seqs, int64_t width, uint32_t* out,
                        int n_threads) {
    init_codes();
    if (n_threads < 1) n_threads = 1;
    int64_t n_words = (width + 6) / 7;

    auto worker = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            const uint8_t* s = seqs + offsets[i];
            int64_t len = offsets[i + 1] - offsets[i];
            if (len > width) len = width;
            uint32_t* dst = out + i * n_words;
            int64_t p = 0;
            for (int64_t w = 0; w < n_words; w++) {
                uint32_t v = 0;
                for (int t = 0; t < 7; t++, p++) {
                    int code = 21;
                    if (p < len) {
                        int8_t c = CHAR_CODE[s[p]];
                        if (c >= 0) code = c;
                    }
                    v = v * 22u + (uint32_t)code;
                }
                dst[w] = v;
            }
        }
    };

    if (n_threads == 1 || n_seqs < 256) {
        worker(0, n_seqs);
    } else {
        std::vector<std::thread> ts;
        int64_t chunk = (n_seqs + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            int64_t lo = t * chunk, hi = std::min(n_seqs, lo + chunk);
            if (lo < hi) ts.emplace_back(worker, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    return n_seqs * n_words;
}

// Parallel LSD radix sort of uint64 (8 passes of 8 bits).
void kt_sort_u64(uint64_t* data, int64_t n, int n_threads) {
    if (n <= 1) return;
    if (n_threads < 1) n_threads = 1;
    std::vector<uint64_t> tmp(n);
    uint64_t* src = data;
    uint64_t* dst = tmp.data();

    int64_t chunk = (n + n_threads - 1) / n_threads;

    for (int pass = 0; pass < 8; pass++) {
        int shift = pass * 8;
        // per-thread histograms
        std::vector<std::vector<int64_t>> hist(n_threads,
                                               std::vector<int64_t>(256, 0));
        {
            std::vector<std::thread> ts;
            for (int t = 0; t < n_threads; t++) {
                int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
                if (lo >= hi) continue;
                ts.emplace_back([&, t, lo, hi]() {
                    auto& h = hist[t];
                    for (int64_t i = lo; i < hi; i++)
                        h[(src[i] >> shift) & 0xFF]++;
                });
            }
            for (auto& t : ts) t.join();
        }
        // global exclusive prefix over (bucket, thread)
        int64_t total = 0;
        std::vector<std::vector<int64_t>> start(n_threads,
                                                std::vector<int64_t>(256, 0));
        for (int b = 0; b < 256; b++) {
            for (int t = 0; t < n_threads; t++) {
                start[t][b] = total;
                total += hist[t][b];
            }
        }
        // scatter
        {
            std::vector<std::thread> ts;
            for (int t = 0; t < n_threads; t++) {
                int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
                if (lo >= hi) continue;
                ts.emplace_back([&, t, lo, hi]() {
                    auto pos = start[t];
                    for (int64_t i = lo; i < hi; i++)
                        dst[pos[(src[i] >> shift) & 0xFF]++] = src[i];
                });
            }
            for (auto& t : ts) t.join();
        }
        std::swap(src, dst);
    }
    // 8 passes (even) -> result back in data
    if (src != data) std::memcpy(data, src, (size_t)n * 8);
}

// FASTA scanner.  input: raw (already gunzipped) file bytes.
// Outputs (caller-allocated, each sized >= input_len or n_max):
//   seq_buf / seq_off[n+1]      : concatenated uppercased sequences
//   hdr_buf / hdr_off[n+1]      : header lines (without '>')
// Returns the number of entries scanned (capped at n_max).
int64_t kt_parse_fasta(const uint8_t* input, int64_t input_len,
                       uint8_t* seq_buf, int64_t* seq_off,
                       uint8_t* hdr_buf, int64_t* hdr_off, int64_t n_max) {
    int64_t n = 0;
    int64_t sp = 0, hp = 0;
    seq_off[0] = 0;
    hdr_off[0] = 0;
    int64_t i = 0;
    bool in_entry = false;
    while (i < input_len) {
        // line [i, eol)
        int64_t eol = i;
        while (eol < input_len && input[eol] != '\n') eol++;
        int64_t end = eol;
        if (end > i && input[end - 1] == '\r') end--;
        if (end > i) {
            if (input[i] == '>') {
                if (in_entry) {
                    seq_off[n + 1] = sp;
                    hdr_off[n + 1] = hp;
                    n++;
                    if (n >= n_max) return n;
                }
                in_entry = true;
                std::memcpy(hdr_buf + hp, input + i + 1, (size_t)(end - i - 1));
                hp += end - i - 1;
            } else if (in_entry) {
                // strip spaces/tabs, uppercase
                for (int64_t k = i; k < end; k++) {
                    uint8_t c = input[k];
                    if (c == ' ' || c == '\t') continue;
                    if (c >= 'a' && c <= 'z') c -= 32;
                    seq_buf[sp++] = c;
                }
            }
        }
        i = eol + 1;
    }
    if (in_entry) {
        seq_off[n + 1] = sp;
        hdr_off[n + 1] = hp;
        n++;
    }
    return n;
}

// ---------------------------------------------------------------------------
// Six-frame ORF extraction over a batch of DNA sequences.
//
// Exact port of the per-codon scan in kaamer_jax/search/orf.py (itself a
// replica of reference pkg/search/dna.go:65-181): an ORF starts at the frame
// start or at a start codon following a stop, ends at a stop codon
// (included as '*') or the frame end; minimum 21 amino acids; unknown codons
// translate to nothing but advance the in-ORF codon counter; per-sequence
// ORFs are ordered by EndPosition (plus strand) / StartPosition (minus).
//
// Tables are the 65-entry codon arrays from gcode.translation_arrays
// (index b0*16+b1*4+b2 with t=0,c=1,a=2,g=3; 64 = unknown).
//
// Outputs are flat: ORF aa bytes in seq_buf with seq_off, per-ORF int32 meta
// rows (read_idx, StartPosition, EndPosition, PlusStrand), and concatenated
// StartsAlternative lists with alts_off.  Returns the ORF count, or -1 if
// any capacity (seq_cap, alts_cap, max_orfs) would be exceeded.
//
// kt_get_orfs runs scan_orfs_range over [0, n_seqs) either directly
// (n_threads <= 1 or small batches) or as contiguous sequence slices on
// n_threads threads writing per-thread buffers that are stitched in slice
// order -- output is bit-identical to the single-threaded scan.
// ---------------------------------------------------------------------------

static int64_t scan_orfs_range(
                    const uint8_t* dna_buf, const int64_t* dna_off,
                    int64_t r_begin, int64_t r_end, const uint8_t* aa_tab,
                    const uint8_t* start_tab, const uint8_t* stop_tab,
                    uint8_t* seq_buf, int64_t seq_cap, int64_t* seq_off,
                    int32_t* meta, int32_t* alts_buf, int64_t alts_cap,
                    int64_t* alts_off, int64_t max_orfs) {
    int8_t base_code[256];
    uint8_t comp[256];
    for (int i = 0; i < 256; i++) { base_code[i] = -1; comp[i] = (uint8_t)i; }
    const char* bases = "tcag";
    for (int i = 0; i < 4; i++) {
        base_code[(uint8_t)bases[i]] = (int8_t)i;
        base_code[(uint8_t)(bases[i] - 32)] = (int8_t)i;  // uppercase
    }
    comp['a'] = 't'; comp['t'] = 'a'; comp['g'] = 'c'; comp['c'] = 'g';

    int64_t n_orfs = 0, sp = 0, ap = 0;
    seq_off[0] = 0;
    alts_off[0] = 0;
    std::vector<uint8_t> rc;      // reverse complement scratch
    std::vector<int64_t> order;   // per-read ORF sort scratch

    for (int64_t r = r_begin; r < r_end; r++) {
        const uint8_t* dna = dna_buf + dna_off[r];
        int64_t n = dna_off[r + 1] - dna_off[r];
        rc.resize(n);
        for (int64_t i = 0; i < n; i++) {
            uint8_t b = dna[n - 1 - i];
            if (b >= 'A' && b <= 'Z') b += 32;  // lower-case first (dna.go:55)
            rc[i] = comp[b];
        }
        int64_t first_orf = n_orfs;

        for (int frame_pos = 0; frame_pos < 6; frame_pos++) {
            bool plus = frame_pos <= 2;
            int start_off = frame_pos % 3;
            const uint8_t* f = plus ? dna : rc.data();
            int64_t C = (n - start_off) / 3;
            if (n - start_off < 0) C = 0;

            // loop state (mirrors orf.py:91-129)
            bool inside = true;
            int64_t cds_begin_sp = sp;       // seq_buf write start of this ORF
            int64_t alts_begin_ap = ap;
            int64_t start_position =
                plus ? frame_pos + 1 : n - start_off;
            int64_t current_aa_pos = 0, current_i = 0;

            for (int64_t ci = 0; ci < C; ci++) {
                int64_t i = ci * 3;
                current_i = i;
                const uint8_t* cp = f + start_off + i;
                int b0 = base_code[cp[0]], b1 = base_code[cp[1]],
                    b2 = base_code[cp[2]];
                int idx = (b0 < 0 || b1 < 0 || b2 < 0)
                              ? 64 : b0 * 16 + b1 * 4 + b2;
                uint8_t aa = aa_tab[idx];
                bool is_start = start_tab[idx], is_stop = stop_tab[idx];

                if (is_start) {
                    if (!inside) {
                        inside = true;
                        current_aa_pos = 0;
                        start_position = plus ? frame_pos + i + 1
                                              : n - (frame_pos + i) + 3;
                    }
                    if (ap >= alts_cap) return -1;
                    alts_buf[ap++] = (int32_t)current_aa_pos;
                }
                if (inside && aa) {
                    if (sp >= seq_cap) return -1;
                    seq_buf[sp++] = aa;
                }
                if (is_stop) {
                    int64_t aa_count = sp - cds_begin_sp;
                    if (inside && aa_count >= 21) {
                        if (n_orfs >= max_orfs) return -1;
                        int64_t end_position =
                            plus ? i + 3 + frame_pos
                                 : start_position - aa_count * 3 + 1;
                        meta[n_orfs * 4 + 0] = (int32_t)r;
                        meta[n_orfs * 4 + 1] = (int32_t)start_position;
                        meta[n_orfs * 4 + 2] = (int32_t)end_position;
                        meta[n_orfs * 4 + 3] = plus ? 1 : 0;
                        seq_off[n_orfs + 1] = sp;
                        alts_off[n_orfs + 1] = ap;
                        n_orfs++;
                    } else {
                        sp = cds_begin_sp;   // discard buffered aas/alts
                        ap = alts_begin_ap;
                    }
                    cds_begin_sp = sp;
                    alts_begin_ap = ap;
                    inside = false;
                }
                current_aa_pos++;
            }
            int64_t aa_count = sp - cds_begin_sp;
            if (inside && aa_count >= 21) {
                if (n_orfs >= max_orfs) return -1;
                int64_t end_position =
                    plus ? current_i + 3 + frame_pos
                         : start_position - aa_count * 3 + 1;
                meta[n_orfs * 4 + 0] = (int32_t)r;
                meta[n_orfs * 4 + 1] = (int32_t)start_position;
                meta[n_orfs * 4 + 2] = (int32_t)end_position;
                meta[n_orfs * 4 + 3] = plus ? 1 : 0;
                seq_off[n_orfs + 1] = sp;
                alts_off[n_orfs + 1] = ap;
                n_orfs++;
            } else {
                sp = cds_begin_sp;
                ap = alts_begin_ap;
            }
        }

        // order this read's ORFs by EndPosition (plus) / StartPosition
        // (minus), stable (dna.go:167-178; orf.py:138-139).  The flat
        // buffers are permuted via scratch copies (counts are small).
        int64_t cnt = n_orfs - first_orf;
        if (cnt > 1) {
            order.resize(cnt);
            for (int64_t k = 0; k < cnt; k++) order[k] = first_orf + k;
            std::stable_sort(order.begin(), order.end(),
                [&](int64_t a, int64_t b) {
                    int32_t ka = meta[a * 4 + 3] ? meta[a * 4 + 2]
                                                 : meta[a * 4 + 1];
                    int32_t kb = meta[b * 4 + 3] ? meta[b * 4 + 2]
                                                 : meta[b * 4 + 1];
                    return ka < kb;
                });
            std::vector<int32_t> m2(cnt * 4);
            std::vector<uint8_t> s2(sp - seq_off[first_orf]);
            std::vector<int32_t> a2(ap - alts_off[first_orf]);
            std::vector<int64_t> so2(cnt + 1), ao2(cnt + 1);
            int64_t s_base = seq_off[first_orf], a_base = alts_off[first_orf];
            int64_t s_w = 0, a_w = 0;
            for (int64_t k = 0; k < cnt; k++) {
                int64_t src = order[k];
                std::memcpy(&m2[k * 4], &meta[src * 4], 4 * sizeof(int32_t));
                so2[k] = s_w; ao2[k] = a_w;
                int64_t sl = seq_off[src + 1] - seq_off[src];
                std::memcpy(&s2[s_w], seq_buf + seq_off[src], sl);
                s_w += sl;
                int64_t al = alts_off[src + 1] - alts_off[src];
                std::memcpy(&a2[a_w], alts_buf + alts_off[src],
                            al * sizeof(int32_t));
                a_w += al;
            }
            so2[cnt] = s_w; ao2[cnt] = a_w;
            std::memcpy(&meta[first_orf * 4], m2.data(),
                        cnt * 4 * sizeof(int32_t));
            std::memcpy(seq_buf + s_base, s2.data(), s_w);
            std::memcpy(alts_buf + a_base, a2.data(), a_w * sizeof(int32_t));
            for (int64_t k = 0; k <= cnt; k++) {
                seq_off[first_orf + k] = s_base + so2[k];
                alts_off[first_orf + k] = a_base + ao2[k];
            }
        }
    }
    return n_orfs;
}

int64_t kt_get_orfs(const uint8_t* dna_buf, const int64_t* dna_off,
                    int64_t n_seqs, const uint8_t* aa_tab,
                    const uint8_t* start_tab, const uint8_t* stop_tab,
                    uint8_t* seq_buf, int64_t seq_cap, int64_t* seq_off,
                    int32_t* meta, int32_t* alts_buf, int64_t alts_cap,
                    int64_t* alts_off, int64_t max_orfs, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads == 1 || n_seqs < 256) {
        return scan_orfs_range(dna_buf, dna_off, 0, n_seqs, aa_tab, start_tab,
                               stop_tab, seq_buf, seq_cap, seq_off, meta,
                               alts_buf, alts_cap, alts_off, max_orfs);
    }

    // contiguous sequence slices; per-thread output buffers sized by the
    // same analytic bounds the Python wrapper uses, applied to slice bases
    int T = n_threads;
    std::vector<int64_t> bounds(T + 1);
    for (int t = 0; t <= T; t++)
        bounds[t] = n_seqs * t / T;

    struct Slice {
        std::vector<uint8_t> seq;
        std::vector<int64_t> soff;
        std::vector<int32_t> meta;
        std::vector<int32_t> alts;
        std::vector<int64_t> aoff;
        int64_t n_orfs = 0;
    };
    std::vector<Slice> slices(T);
    std::atomic<bool> failed(false);
    std::vector<std::thread> ts;
    for (int t = 0; t < T; t++) {
        ts.emplace_back([&, t]() {
            int64_t r0 = bounds[t], r1 = bounds[t + 1];
            int64_t cnt = r1 - r0;
            int64_t bases = dna_off[r1] - dna_off[r0];
            int64_t scap = 2 * bases + 12 * cnt + 64;
            int64_t acap = bases + 6 * cnt + 64;
            int64_t mcap = 2 * bases / (3 * 21) + 6 * cnt + 64;
            Slice& s = slices[t];
            s.seq.resize(scap);
            s.soff.resize(mcap + 1);
            s.meta.resize(mcap * 4);
            s.alts.resize(acap);
            s.aoff.resize(mcap + 1);
            int64_t n = scan_orfs_range(
                dna_buf, dna_off, r0, r1, aa_tab, start_tab, stop_tab,
                s.seq.data(), scap, s.soff.data(), s.meta.data(),
                s.alts.data(), acap, s.aoff.data(), mcap);
            if (n < 0) failed.store(true);
            s.n_orfs = n;
        });
    }
    for (auto& th : ts) th.join();
    if (failed.load()) return -1;

    // stitch in slice order, rebasing offsets -- identical layout to the
    // single-threaded scan
    int64_t n_orfs = 0, sp = 0, ap = 0;
    seq_off[0] = 0;
    alts_off[0] = 0;
    for (int t = 0; t < T; t++) {
        Slice& s = slices[t];
        int64_t s_len = s.soff[s.n_orfs];
        int64_t a_len = s.aoff[s.n_orfs];
        if (n_orfs + s.n_orfs > max_orfs || sp + s_len > seq_cap ||
            ap + a_len > alts_cap)
            return -1;
        std::memcpy(seq_buf + sp, s.seq.data(), s_len);
        std::memcpy(meta + n_orfs * 4, s.meta.data(),
                    s.n_orfs * 4 * sizeof(int32_t));
        std::memcpy(alts_buf + ap, s.alts.data(), a_len * sizeof(int32_t));
        for (int64_t k = 1; k <= s.n_orfs; k++) {
            seq_off[n_orfs + k] = sp + s.soff[k];
            alts_off[n_orfs + k] = ap + s.aoff[k];
        }
        sp += s_len;
        ap += a_len;
        n_orfs += s.n_orfs;
    }
    return n_orfs;
}

}  // extern "C"
