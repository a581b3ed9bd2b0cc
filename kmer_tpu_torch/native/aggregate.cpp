// aggregate.cpp — multithreaded host aggregation of (key, count) pairs
// into a sorted unique table: the native core behind
// kmer_tpu.pipeline.table.KmerTable.from_pairs (see nativeagg.py).
//
// The reference's whole hot path is a single-threaded std sort of
// 54-char strings (/root/reference/k-mer-count/src/main.rs:87); here
// keys are packed 2-bit-code integers and the host aggregation is a
// bucket-parallel sort + run-length reduce so the host merge keeps up
// with the device pipeline on many-core production hosts (the numpy
// argsort/lexsort core is single-threaded).
//
// Contract (extern "C" aggregate_pairs):
//   keys:     (n, nw) uint64, C-contiguous, most-significant word
//             FIRST.  nw == 1 or 2 — 2 gives 128-bit keys, which covers
//             every supported k (k <= 63 -> <= 126 key bits).
//   counts:   (n,) int64
//   out_keys / out_counts: caller-allocated, capacity n rows
//   returns   m = number of unique keys (m <= n), or
//             -1 bad arguments / -2 allocation failure
//
// Output is ascending lexicographic by (word0, word1) with counts of
// equal keys summed in int64 — bit-identical to the numpy path
// (integer addition is order-independent, so thread scheduling cannot
// change the result).
//
// Algorithm: one parallel max pass finds the top 8 *significant* bits
// of the key range (DNA keys occupy only the low 2k bits, so a fixed
// top-byte MSD partition would degenerate to one bucket); keys are
// scattered into <= 256 range-ordered buckets (parallel histogram +
// per-(thread,bucket) cursors), each bucket is sorted and run-reduced
// independently (dynamic work queue), and the per-bucket unique runs
// are prefix-summed and copied out in parallel.  Bucket order ==
// global key order, so no final merge is needed.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <thread>
#include <vector>

namespace {

struct Pair {            // one (key, count) record; 128-bit key as hi:lo
    uint64_t hi, lo;
    int64_t c;
};

inline bool pair_lt(const Pair& a, const Pair& b) {
    return a.hi != b.hi ? a.hi < b.hi : a.lo < b.lo;
}
inline bool key_eq(const Pair& a, const Pair& b) {
    return a.hi == b.hi && a.lo == b.lo;
}

inline int bit_width_u64(uint64_t x) {
    return x ? 64 - __builtin_clzll(x) : 0;
}

template <class F>
void run_threads(int nt, F fn) {
    if (nt <= 1) { fn(0); return; }
    std::vector<std::thread> th;
    th.reserve(nt);
    for (int t = 0; t < nt; ++t) th.emplace_back(fn, t);
    for (auto& x : th) x.join();
}

// read record i of the caller's (n, nw) MS-first key matrix
inline void load_key(const uint64_t* keys, int nw, int64_t i,
                     uint64_t& hi, uint64_t& lo) {
    if (nw == 1) { hi = 0; lo = keys[i]; }
    else         { hi = keys[2 * i]; lo = keys[2 * i + 1]; }
}

// top-8-significant-bits bucket of a 128-bit key, given the shift
// derived from the global max (bucket < 256; ascending bucket ==
// ascending key because it is a plain right shift of the key)
inline uint32_t bucket_of(uint64_t hi, uint64_t lo, int shift) {
    if (shift == 0) return static_cast<uint32_t>(lo);        // max < 256
    if (shift >= 64) return static_cast<uint32_t>(hi >> (shift - 64));
    return static_cast<uint32_t>((hi << (64 - shift)) | (lo >> shift));
}

constexpr int NB = 256;      // buckets

// LSD radix sort of one bucket's records by the low `bits` key bits
// (the bucket prefix above them is constant within a bucket).  Byte
// counting passes are stable, so the full key ends sorted; ~2x
// std::sort on large buckets (it replaces ~15 compare levels with
// ceil(bits/8) streaming passes).  `tmp` must hold n records; result
// lands back in `a`.
inline uint32_t key_byte(const Pair& p, int sh) {
    if (sh + 8 <= 64) return static_cast<uint32_t>(p.lo >> sh) & 0xffu;
    if (sh >= 64) return static_cast<uint32_t>(p.hi >> (sh - 64)) & 0xffu;
    return static_cast<uint32_t>((p.lo >> sh) | (p.hi << (64 - sh))) & 0xffu;
}

void radix_sort_bucket(Pair* a, Pair* tmp, int64_t n, int bits) {
    const int passes = (bits + 7) / 8;
    Pair* src = a;
    Pair* dst = tmp;
    for (int p = 0; p < passes; ++p) {
        const int sh = p * 8;
        int64_t cnt[256] = {0};
        for (int64_t i = 0; i < n; ++i) cnt[key_byte(src[i], sh)]++;
        // degenerate pass (all records share this byte): skip scatter
        if (cnt[key_byte(src[0], sh)] == n) continue;
        int64_t pos[256];
        int64_t acc = 0;
        for (int b = 0; b < 256; ++b) { pos[b] = acc; acc += cnt[b]; }
        for (int64_t i = 0; i < n; ++i)
            dst[pos[key_byte(src[i], sh)]++] = src[i];
        std::swap(src, dst);
    }
    if (src != a) std::memcpy(a, src, static_cast<size_t>(n) * sizeof(Pair));
}

// below this std::sort's cache behavior wins (and the scratch memcpy
// overhead matters); measured crossover is a few thousand records
constexpr int64_t RADIX_MIN = 4096;

int64_t aggregate(const uint64_t* keys, const int64_t* counts, int64_t n,
                  int nw, int nt, uint64_t* out_keys, int64_t* out_counts) {
    // slice bounds for thread t
    auto lo_of = [&](int t) { return n * t / nt; };
    auto hi_of = [&](int t) { return n * (t + 1) / nt; };

    // ---- pass A: global max key (sets the bucket shift) ----
    std::vector<uint64_t> mx_hi(nt, 0), mx_lo(nt, 0);
    run_threads(nt, [&](int t) {
        uint64_t mh = 0, ml = 0;
        for (int64_t i = lo_of(t); i < hi_of(t); ++i) {
            uint64_t h, l;
            load_key(keys, nw, i, h, l);
            if (h > mh || (h == mh && l > ml)) { mh = h; ml = l; }
        }
        mx_hi[t] = mh; mx_lo[t] = ml;
    });
    uint64_t mh = 0, ml = 0;
    for (int t = 0; t < nt; ++t)
        if (mx_hi[t] > mh || (mx_hi[t] == mh && mx_lo[t] > ml)) {
            mh = mx_hi[t]; ml = mx_lo[t];
        }
    const int width = mh ? 64 + bit_width_u64(mh) : bit_width_u64(ml);
    const int shift = width > 8 ? width - 8 : 0;

    // ---- pass B: per-thread bucket histograms ----
    std::vector<int64_t> hist(static_cast<size_t>(nt) * NB, 0);
    run_threads(nt, [&](int t) {
        int64_t* h = hist.data() + static_cast<size_t>(t) * NB;
        for (int64_t i = lo_of(t); i < hi_of(t); ++i) {
            uint64_t kh, kl;
            load_key(keys, nw, i, kh, kl);
            h[bucket_of(kh, kl, shift)]++;
        }
    });

    // bucket starts + per-(thread,bucket) write cursors: thread t's
    // records of bucket b land after threads < t's, so the scatter is
    // race-free without atomics (input order inside a bucket is
    // irrelevant — the bucket gets sorted)
    std::vector<int64_t> bstart(NB + 1, 0);
    std::vector<int64_t> cur(static_cast<size_t>(nt) * NB);
    {
        int64_t acc = 0;
        for (int b = 0; b < NB; ++b) {
            bstart[b] = acc;
            for (int t = 0; t < nt; ++t) {
                cur[static_cast<size_t>(t) * NB + b] = acc;
                acc += hist[static_cast<size_t>(t) * NB + b];
            }
        }
        bstart[NB] = acc;     // == n
    }

    // ---- pass C: scatter into bucket-contiguous records ----
    // uninitialized storage: every slot is written here (a
    // std::vector would serially zero-fill 24n bytes first)
    std::unique_ptr<Pair[]> buf(new Pair[static_cast<size_t>(n)]);
    run_threads(nt, [&](int t) {
        int64_t* c = cur.data() + static_cast<size_t>(t) * NB;
        for (int64_t i = lo_of(t); i < hi_of(t); ++i) {
            uint64_t kh, kl;
            load_key(keys, nw, i, kh, kl);
            Pair& p = buf[c[bucket_of(kh, kl, shift)]++];
            p.hi = kh; p.lo = kl; p.c = counts[i];
        }
    });

    // ---- pass D: sort + run-reduce each bucket (dynamic queue) ----
    // buckets are processed LARGEST FIRST (better tail-latency balance,
    // and each thread's lazy radix scratch is then allocated once at
    // the biggest size it will ever need — threads that only ever see
    // small buckets allocate nothing)
    std::vector<int64_t> uniq(NB, 0);
    std::atomic<int> next(0);
    int order[NB];
    for (int b = 0; b < NB; ++b) order[b] = b;
    std::sort(order, order + NB, [&](int a2, int b2) {
        return bstart[a2 + 1] - bstart[a2] > bstart[b2 + 1] - bstart[b2];
    });
    run_threads(nt, [&](int) {
        std::unique_ptr<Pair[]> scratch;
        int64_t scratch_n = 0;
        for (;;) {
            const int qi = next.fetch_add(1);
            if (qi >= NB) return;
            const int b = order[qi];
            const int64_t s = bstart[b], e = bstart[b + 1];
            if (s == e) continue;
            const int64_t nb = e - s;
            bool radix = nb >= RADIX_MIN && shift > 0;
            if (radix && nb > scratch_n) {
                // allocation INSIDE a worker must not throw out of the
                // thread body (std::terminate) — fall back to
                // std::sort for this bucket instead
                try {
                    scratch.reset(new Pair[static_cast<size_t>(nb)]);
                    scratch_n = nb;
                } catch (const std::bad_alloc&) {
                    scratch.reset();
                    scratch_n = 0;
                    radix = false;
                }
            }
            if (radix)
                radix_sort_bucket(buf.get() + s, scratch.get(), nb, shift);
            else
                std::sort(buf.get() + s, buf.get() + e, pair_lt);
            int64_t w = s;
            for (int64_t i = s + 1; i < e; ++i) {
                if (key_eq(buf[i], buf[w])) buf[w].c += buf[i].c;
                else buf[++w] = buf[i];
            }
            uniq[b] = w - s + 1;
        }
    });

    // ---- pass E: prefix out offsets, parallel copy-out ----
    std::vector<int64_t> ostart(NB + 1, 0);
    for (int b = 0; b < NB; ++b) ostart[b + 1] = ostart[b] + uniq[b];
    run_threads(nt, [&](int t) {
        for (int b = t; b < NB; b += nt) {
            const int64_t s = bstart[b];
            int64_t o = ostart[b];
            for (int64_t i = 0; i < uniq[b]; ++i, ++o) {
                const Pair& p = buf[s + i];
                if (nw == 1) out_keys[o] = p.lo;
                else { out_keys[2 * o] = p.hi; out_keys[2 * o + 1] = p.lo; }
                out_counts[o] = p.c;
            }
        }
    });
    return ostart[NB];
}

}  // namespace

extern "C" int64_t aggregate_pairs(const uint64_t* keys,
                                   const int64_t* counts, int64_t n, int nw,
                                   int n_threads, uint64_t* out_keys,
                                   int64_t* out_counts) {
    if (n < 0 || (nw != 1 && nw != 2)) return -1;
    if (n == 0) return 0;
    int nt = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
    // don't spin threads that would each see < ~64k records
    const int64_t per = 64 * 1024;
    if (n / per + 1 < nt) nt = static_cast<int>(n / per + 1);
    try {
        return aggregate(keys, counts, n, nw, nt, out_keys, out_counts);
    } catch (const std::bad_alloc&) {
        return -2;
    }
}

// format_tsv — render n table rows as "BASES\tCOUNT\n" ASCII in one
// multithreaded pass (KmerTable.write_tsv's hot path: numpy's
// np.char.mod b"%d" is a per-row printf).  Rows are variable-length
// (count digits vary), so offsets are prefix-summed first and the fill
// is embarrassingly parallel.  Returns total bytes written, or -1 on
// bad arguments / insufficient out_cap.
extern "C" int64_t format_tsv(const uint32_t* words, const int64_t* counts,
                              int64_t n, int w, int n_bases,
                              int n_threads, uint8_t* out,
                              int64_t out_cap) {
    if (n < 0 || w < 1 || n_bases < 1 || n_bases > 16 * w) return -1;
    if (n == 0) return 0;
    int nt = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
    const int64_t per = 64 * 1024;
    if (n / per + 1 < nt) nt = static_cast<int>(n / per + 1);

    auto digits_of = [](int64_t v) -> int {
        uint64_t u;
        int d = 1;
        if (v < 0) {                    // '-' + digits; INT64_MIN-safe
            u = static_cast<uint64_t>(-(v + 1)) + 1;
            d = 2;
        } else {
            u = static_cast<uint64_t>(v);
        }
        while (u >= 10) { u /= 10; ++d; }
        return d;
    };
    try {
        // pass 1: per-row byte offsets (parallel digit count, serial
        // prefix — the prefix is a trivial fraction of the fill)
        std::vector<int64_t> off(static_cast<size_t>(n) + 1, 0);
        run_threads(nt, [&](int t) {
            const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            for (int64_t i = lo; i < hi; ++i)
                off[i + 1] = n_bases + 1 + digits_of(counts[i]) + 1;
        });
        for (int64_t i = 0; i < n; ++i) off[i + 1] += off[i];
        if (off[n] > out_cap) return -1;

        std::vector<int> wi(n_bases), sh(n_bases);
        for (int j = 0; j < n_bases; ++j) {
            const int bitpos = 2 * (n_bases - 1 - j);
            wi[j] = w - 1 - bitpos / 32;
            sh[j] = bitpos % 32;
        }
        static const uint8_t ACGT[4] = {'A', 'C', 'G', 'T'};
        run_threads(nt, [&](int t) {
            const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            for (int64_t i = lo; i < hi; ++i) {
                const uint32_t* row = words + static_cast<size_t>(i) * w;
                uint8_t* o = out + off[i];
                for (int j = 0; j < n_bases; ++j)
                    o[j] = ACGT[(row[wi[j]] >> sh[j]) & 3u];
                o += n_bases;
                *o++ = '\t';
                uint8_t* end = out + off[i + 1];
                *(end - 1) = '\n';
                // digits right-to-left into the pre-sized slot
                int64_t v = counts[i];
                uint8_t* d = end - 2;
                if (v < 0) {
                    uint64_t u = static_cast<uint64_t>(-(v + 1)) + 1;
                    while (u >= 10) { *d-- = '0' + u % 10; u /= 10; }
                    *d-- = '0' + static_cast<int>(u);
                    *d = '-';
                } else {
                    do { *d-- = '0' + v % 10; v /= 10; } while (v);
                }
            }
        });
        return off[n];
    } catch (const std::bad_alloc&) {
        return -1;
    }
}

// decode_lines — batch-decode (n, W) uint32 key words (std MS-first
// layout, 2 bits/base) into ASCII rows of n_bases chars (+ optional
// trailing '\n').  The host analog of the reference's stdout loop
// (main.rs:88-90); replaces ops/encode's n_bases strided numpy passes
// with one multithreaded pass over the rows (parity dump / TSV dump
// hot path).  out must hold n * (n_bases + newline) bytes.
extern "C" int decode_lines(const uint32_t* words, int64_t n, int w,
                            int n_bases, int newline, int n_threads,
                            uint8_t* out) {
    if (n < 0 || w < 1 || n_bases < 1 || n_bases > 16 * w) return -1;
    if (n == 0) return 0;
    // per-char source (word index, shift), hoisted out of the row loop
    std::vector<int> wi(n_bases), sh(n_bases);
    for (int j = 0; j < n_bases; ++j) {
        const int bitpos = 2 * (n_bases - 1 - j);
        wi[j] = w - 1 - bitpos / 32;
        sh[j] = bitpos % 32;
    }
    static const uint8_t ACGT[4] = {'A', 'C', 'G', 'T'};
    const int stride = n_bases + (newline ? 1 : 0);
    int nt = n_threads < 1 ? 1 : (n_threads > 64 ? 64 : n_threads);
    const int64_t per = 64 * 1024;
    if (n / per + 1 < nt) nt = static_cast<int>(n / per + 1);
    run_threads(nt, [&](int t) {
        const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
        for (int64_t i = lo; i < hi; ++i) {
            const uint32_t* row = words + static_cast<size_t>(i) * w;
            uint8_t* o = out + static_cast<size_t>(i) * stride;
            for (int j = 0; j < n_bases; ++j)
                o[j] = ACGT[(row[wi[j]] >> sh[j]) & 3u];
            if (newline) o[n_bases] = '\n';
        }
    });
    return 0;
}
