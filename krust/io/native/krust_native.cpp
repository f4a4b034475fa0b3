// Native host parser/packer for krust.
//
// Single-pass FASTA/FASTQ parsers that transform raw file bytes directly into
// the separator-delimited 2-bit code stream the device codec consumes — the
// native-performance equivalent of the reference's reader + per-base
// validation loops (reference: src/reader.rs:82-247, src/kmer.rs:266-286),
// exposed over a C ABI for ctypes.
//
// Semantics match krust/io/reader.py exactly (differentially tested):
//   - FASTA: '>' header lines; multi-line records concatenate; content before
//     the first header is an error; '\r' stripped; blank lines tolerated.
//   - FASTQ: strict 4-line records; '@' / '+' line checks; seq/qual length
//     equality enforced.
//   - Output: one INVALID (4) code byte between records; per-base codes via
//     the A/C/G/T (case-insensitive) LUT, everything else -> 4.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

// Eagerly populate pages of a fresh allocation. Lazy first-touch faulting
// costs ~45 us/page on some virtualized hosts (measured on this rig:
// 12 s to touch 1 GB), while MADV_POPULATE_WRITE populates the same
// region at ~7 GB/s. No-op (correct, just lazy) where unsupported.
void populate_write(void* ptr, int64_t n_bytes) {
#if defined(__linux__) && defined(MADV_POPULATE_WRITE)
    if (ptr == nullptr || n_bytes <= 0) return;
    const uintptr_t page = 4096;
    uintptr_t a = reinterpret_cast<uintptr_t>(ptr) & ~(page - 1);
    uintptr_t b = (reinterpret_cast<uintptr_t>(ptr) +
                   static_cast<uintptr_t>(n_bytes) + page - 1) &
                  ~(page - 1);
    madvise(reinterpret_cast<void*>(a), b - a, MADV_POPULATE_WRITE);
#else
    (void)ptr;
    (void)n_bytes;
#endif
}

}  // namespace

namespace {

constexpr uint8_t kInvalid = 4;
constexpr uint8_t kQualPad = 0xFF;

struct Lut {
    uint8_t table[256];
    constexpr Lut() : table() {
        for (int i = 0; i < 256; ++i) table[i] = kInvalid;
        table['A'] = table['a'] = 0;
        table['C'] = table['c'] = 1;
        table['G'] = table['g'] = 2;
        table['T'] = table['t'] = 3;
    }
};
constexpr Lut kLut;

}  // namespace

extern "C" {

// Error codes shared with the Python wrapper.
enum KrustParseStatus : int32_t {
    KRUST_OK = 0,
    KRUST_ERR_CONTENT_BEFORE_HEADER = 1,
    KRUST_ERR_BAD_LINE_COUNT = 2,
    KRUST_ERR_BAD_FASTQ_HEADER = 3,
    KRUST_ERR_BAD_FASTQ_PLUS = 4,
    KRUST_ERR_QUAL_LEN_MISMATCH = 5,
};

// Parse FASTA bytes into a code stream.
//   data/len:    raw file bytes
//   out_codes:   caller buffer, capacity >= len (output never exceeds input)
//   out_len:     emitted bytes (codes + separators)
//   n_records:   number of '>' headers
//   n_bases:     emitted base count (excludes separators)
int32_t krust_parse_fasta(const uint8_t* data, int64_t len, uint8_t* out_codes,
                          int64_t* out_len, int64_t* n_records,
                          int64_t* n_bases) {
    int64_t out = 0, records = 0, bases = 0;
    bool in_header = false;
    bool at_line_start = true;
    bool seen_record = false;

    for (int64_t i = 0; i < len; ++i) {
        const uint8_t ch = data[i];
        if (at_line_start) {
            if (ch == '>') {
                in_header = true;
                if (seen_record) out_codes[out++] = kInvalid;
                seen_record = true;
                ++records;
            } else {
                in_header = false;
                if (!seen_record && ch != '\n' && ch != '\r') {
                    return KRUST_ERR_CONTENT_BEFORE_HEADER;
                }
            }
            at_line_start = false;
        }
        if (ch == '\n') {
            at_line_start = true;
            continue;
        }
        if (ch == '\r') continue;
        if (!in_header) {
            out_codes[out++] = kLut.table[ch];
            ++bases;
        }
    }
    *out_len = out;
    *n_records = records;
    *n_bases = bases;
    return KRUST_OK;
}

// Parse FASTQ bytes into aligned code + quality streams.
// out_codes/out_qual capacity >= len. Quality separator byte is 0xFF.
int32_t krust_parse_fastq(const uint8_t* data, int64_t len, uint8_t* out_codes,
                          uint8_t* out_qual, int64_t* out_len,
                          int64_t* n_records, int64_t* n_bases) {
    int64_t out = 0, records = 0, bases = 0;
    int64_t line = 0;
    int64_t i = 0;
    int64_t seq_len_this_record = 0;

    // strip exactly ONE final line terminator (\n or \r\n); stray extra
    // blank lines stay and fail the %4 check (rust-bio strictness), while a
    // legitimate empty final quality line survives (matches io/reader.py)
    if (len > 0 && data[len - 1] == '\n') {
        --len;
        if (len > 0 && data[len - 1] == '\r') --len;
    }

    while (i < len) {
        // find line end (excluding trailing \r)
        int64_t start = i;
        while (i < len && data[i] != '\n') ++i;
        int64_t end = i;
        if (end > start && data[end - 1] == '\r') --end;
        if (i < len) ++i;  // consume '\n'

        const int phase = static_cast<int>(line % 4);
        if (phase == 0) {
            if (end == start || data[start] != '@')
                return KRUST_ERR_BAD_FASTQ_HEADER;
            if (records > 0) {
                out_codes[out] = kInvalid;
                out_qual[out] = kQualPad;
                ++out;
            }
            ++records;
        } else if (phase == 1) {
            seq_len_this_record = end - start;
            for (int64_t j = start; j < end; ++j) {
                out_codes[out + (j - start)] = kLut.table[data[j]];
            }
            bases += seq_len_this_record;
        } else if (phase == 2) {
            if (end == start || data[start] != '+')
                return KRUST_ERR_BAD_FASTQ_PLUS;
        } else {
            if (end - start != seq_len_this_record)
                return KRUST_ERR_QUAL_LEN_MISMATCH;
            std::memcpy(out_qual + out, data + start,
                        static_cast<size_t>(end - start));
            out += seq_len_this_record;
        }
        ++line;
    }
    // a trailing final newline produces no extra line; partial record = error
    if (line % 4 != 0) return KRUST_ERR_BAD_LINE_COUNT;
    *out_len = out;
    *n_records = records;
    *n_bases = bases;
    return KRUST_OK;
}

// 2-bit pack: 4 bases/byte, first base in the high bits. Invalid codes pack
// as (code & 3); their positions travel separately (io/packer.py). Threaded
// over byte-aligned chunks; each output byte depends on 4 input bytes only.
//   codes/n: input stream of 0..4 codes
//   out:     caller buffer, capacity >= ceil(n/4); tail byte zero-padded
void krust_pack2(const uint8_t* codes, int64_t n, uint8_t* out) {
    const int64_t full = n / 4;  // whole output bytes

    auto pack_range = [codes, out](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            const uint8_t* p = codes + b * 4;
            out[b] = static_cast<uint8_t>(((p[0] & 3) << 6) | ((p[1] & 3) << 4) |
                                          ((p[2] & 3) << 2) | (p[3] & 3));
        }
    };

    const int64_t kParallelMin = 1 << 20;
    unsigned hw = std::thread::hardware_concurrency();
    if (full >= kParallelMin && hw > 1) {
        const unsigned n_threads = hw > 16 ? 16 : hw;
        const int64_t chunk = (full + n_threads - 1) / n_threads;
        std::vector<std::thread> workers;
        workers.reserve(n_threads);
        for (unsigned t = 0; t < n_threads; ++t) {
            const int64_t b0 = static_cast<int64_t>(t) * chunk;
            const int64_t b1 = b0 + chunk < full ? b0 + chunk : full;
            if (b0 >= b1) break;
            workers.emplace_back(pack_range, b0, b1);
        }
        for (auto& w : workers) w.join();
    } else {
        pack_range(0, full);
    }

    if (n % 4) {  // tail byte: remaining bases high-to-low, zero-padded
        uint8_t v = 0;
        for (int64_t i = full * 4; i < n; ++i) {
            v |= static_cast<uint8_t>((codes[i] & 3) << (6 - 2 * (i - full * 4)));
        }
        out[full] = v;
    }
}

// Fused stream scan: 2-bit pack + invalid-position extraction (+quality
// fold) in ONE pass over the stream — the host side of the flat transfer
// path (io/packer.py flat_batches). One pass matters: every extra numpy
// pass over a multi-hundred-MB stream costs seconds.
//
// Threaded over byte-aligned chunks: each worker packs its own packed2
// range in place (output bytes are independent) and collects invalid
// positions into a per-thread buffer; buffers stitch back in chunk order,
// so invpos stays ascending exactly as the single-thread scan emits it.
// Thread count: KRUST_NATIVE_THREADS env override (tests force >1 on
// single-core hosts, where it also drops the size threshold so small
// inputs exercise the stitch), else hardware_concurrency when the stream
// is large enough to amortize thread spawns.
//   codes/n:  input stream of 0..4 codes
//   qual:     optional aligned quality bytes (nullptr when unused)
//   thr:      quality threshold; bases with qual < thr are invalid (-1: off)
//   packed2:  caller buffer, capacity >= ceil(n/4) (tail zero-padded)
//   invpos:   caller buffer for invalid positions, capacity max_inv
// Returns the number of invalid positions found, or max_inv + 1 the moment
// the count would exceed max_inv (early exit; caller falls back to the
// dense-mask path and must discard the partial outputs).

namespace {

// Scan output-byte range [b0, b1): pack into packed2, append invalid input
// positions to inv. The cap on buffered positions is a budget SHARED by all
// workers (*n_used counts every position buffered anywhere): total memory
// held across threads stays <= cap entries — same bound as the sequential
// scan — instead of cap per thread. Sets *overflow and stops early when the
// budget runs out (the whole scan's outputs are discarded on overflow).
void scan_range(const uint8_t* codes, const uint8_t* qual, int32_t thr,
                uint8_t* packed2, int64_t b0, int64_t b1,
                std::vector<int64_t>& inv, int64_t cap,
                std::atomic<int64_t>* n_used, std::atomic<bool>* overflow) {
    for (int64_t b = b0; b < b1; ++b) {
        if ((b & 0xFFF) == 0 && overflow && overflow->load(std::memory_order_relaxed))
            return;
        const int64_t i = b * 4;
        const uint8_t c0 = codes[i], c1 = codes[i + 1], c2 = codes[i + 2],
                      c3 = codes[i + 3];
        packed2[b] = static_cast<uint8_t>(((c0 & 3) << 6) | ((c1 & 3) << 4) |
                                          ((c2 & 3) << 2) | (c3 & 3));
        if ((c0 | c1 | c2 | c3) > 3 ||
            (qual && (qual[i] < thr || qual[i + 1] < thr || qual[i + 2] < thr ||
                      qual[i + 3] < thr))) {
            for (int j = 0; j < 4; ++j) {
                if (codes[i + j] > 3 || (qual && qual[i + j] < thr)) {
                    // atomic per buffered position: invalids are rare on this
                    // path (invalid-heavy streams trip the overflow bail and
                    // rescan dense), so contention is transient by design
                    if (n_used->fetch_add(1, std::memory_order_relaxed) >= cap) {
                        if (overflow) overflow->store(true, std::memory_order_relaxed);
                        return;
                    }
                    inv.push_back(i + j);  // int64: streams exceed 2^31
                }
            }
        }
    }
}

}  // namespace

int64_t krust_scan_stream(const uint8_t* codes, int64_t n, const uint8_t* qual,
                          int32_t thr, uint8_t* packed2, int64_t* invpos,
                          int64_t max_inv) {
    const int64_t full = n / 4;

    unsigned n_threads = 1;
    int64_t parallel_min = int64_t(1) << 18;  // 1 MB of stream
    if (const char* env = std::getenv("KRUST_NATIVE_THREADS")) {
        const long forced = std::strtol(env, nullptr, 10);
        if (forced > 1) {
            n_threads = static_cast<unsigned>(forced > 64 ? 64 : forced);
            parallel_min = 16;  // forced: exercise the stitch on tiny inputs
        }
    } else {
        const unsigned hw = std::thread::hardware_concurrency();
        n_threads = hw > 16 ? 16 : (hw ? hw : 1);
    }

    int64_t n_inv = 0;
    if (n_threads > 1 && full >= parallel_min) {
        const int64_t chunk = (full + n_threads - 1) / n_threads;
        std::atomic<bool> overflow{false};
        std::atomic<int64_t> used{0};  // shared budget: <= max_inv buffered TOTAL
        std::vector<std::vector<int64_t>> local(n_threads);
        std::vector<std::thread> workers;
        workers.reserve(n_threads);
        for (unsigned t = 0; t < n_threads; ++t) {
            const int64_t b0 = static_cast<int64_t>(t) * chunk;
            const int64_t b1 = b0 + chunk < full ? b0 + chunk : full;
            if (b0 >= b1) break;
            workers.emplace_back([&, t, b0, b1] {
                scan_range(codes, qual, thr, packed2, b0, b1, local[t],
                           max_inv, &used, &overflow);
            });
        }
        for (auto& w : workers) w.join();
        int64_t total = 0;
        for (const auto& v : local) total += static_cast<int64_t>(v.size());
        if (overflow.load(std::memory_order_relaxed) || total > max_inv)
            return max_inv + 1;
        for (const auto& v : local) {  // chunk order keeps invpos ascending
            std::memcpy(invpos + n_inv, v.data(), v.size() * sizeof(int64_t));
            n_inv += static_cast<int64_t>(v.size());
        }
    } else {
        std::atomic<bool> overflow{false};
        std::atomic<int64_t> used{0};
        std::vector<int64_t> inv;
        scan_range(codes, qual, thr, packed2, 0, full, inv, max_inv, &used,
                   &overflow);
        if (overflow.load(std::memory_order_relaxed)) return max_inv + 1;
        std::memcpy(invpos, inv.data(), inv.size() * sizeof(int64_t));
        n_inv = static_cast<int64_t>(inv.size());
    }

    if (n % 4) {
        uint8_t v = 0;
        for (int64_t i = full * 4; i < n; ++i) {
            v |= static_cast<uint8_t>((codes[i] & 3) << (6 - 2 * (i - full * 4)));
            if (codes[i] > 3 || (qual && qual[i] < thr)) {
                if (n_inv >= max_inv) return max_inv + 1;
                invpos[n_inv++] = i;
            }
        }
        packed2[full] = v;
    }
    return n_inv;
}

}  // extern "C" (reopened after the template helpers below)

// Reusable scratch for the radix counting paths. Cached across calls so
// repeated counts don't pay a fresh page-fault storm per invocation; a
// concurrent second caller (async API) simply mallocs its own transient
// buffer instead of blocking.
namespace {

struct ScratchCache {
    std::mutex mu;
    uint8_t* buf = nullptr;
    int64_t cap = 0;  // in bytes
};
ScratchCache g_scratch;

class ScratchLease {
   public:
    // Leases above this stay transient (freed at destruction) so one huge
    // count doesn't pin gigabytes for the process lifetime.
    static constexpr int64_t kMaxCachedBytes = int64_t{1} << 30;

    explicit ScratchLease(int64_t n_bytes) {
        if (n_bytes <= kMaxCachedBytes && g_scratch.mu.try_lock()) {
            owned_lock_ = true;
            if (g_scratch.cap < n_bytes) {
                std::free(g_scratch.buf);
                g_scratch.buf = static_cast<uint8_t*>(std::malloc(n_bytes));
                g_scratch.cap = g_scratch.buf ? n_bytes : 0;
                populate_write(g_scratch.buf, n_bytes);
            }
            ptr_ = g_scratch.buf;
        }
        if (ptr_ == nullptr) {  // cache busy or malloc failed: transient
            transient_ = static_cast<uint8_t*>(std::malloc(n_bytes));
            ptr_ = transient_;
            populate_write(transient_, n_bytes);
            if (owned_lock_) {
                g_scratch.mu.unlock();
                owned_lock_ = false;
            }
        }
    }
    ~ScratchLease() {
        if (owned_lock_) g_scratch.mu.unlock();
        std::free(transient_);
    }
    void* get() const { return ptr_; }

   private:
    uint8_t* ptr_ = nullptr;
    uint8_t* transient_ = nullptr;
    bool owned_lock_ = false;
};

// Thread-count policy shared by the counting core: KRUST_NATIVE_THREADS
// forces a count (and drops the size threshold so tests exercise the
// multi-thread code on tiny inputs), else hardware_concurrency when the
// work is large enough to amortize thread spawns.
unsigned pick_threads(int64_t work_units, int64_t parallel_min) {
    unsigned n_threads = 1;
    if (const char* env = std::getenv("KRUST_NATIVE_THREADS")) {
        const long forced = std::strtol(env, nullptr, 10);
        if (forced > 1) {
            n_threads = static_cast<unsigned>(forced > 64 ? 64 : forced);
            parallel_min = 2;
        }
    } else {
        const unsigned hw = std::thread::hardware_concurrency();
        n_threads = hw > 16 ? 16 : (hw ? hw : 1);
    }
    if (work_units < parallel_min) return 1;
    return n_threads;
}

// Rolling canonical window scan emitting only windows whose END index lies
// in [e0, e1). The scan warms up from e0-(k-1) so the window state at e0 is
// exact — the (k-1)-base halo that makes range-parallel rolling equivalent
// to the sequential scan (every window's k bases lie within the scan).
template <typename Emit>
inline void roll_range(const uint8_t* codes, const uint8_t* qual, int32_t thr,
                       int k, int64_t e0, int64_t e1, Emit&& emit) {
    const uint64_t mask = k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int rc_shift = 2 * (k - 1);
    uint64_t fwd = 0, rc = 0;
    int64_t run = 0;
    const int64_t scan0 = e0 > int64_t{k - 1} ? e0 - (k - 1) : 0;
    for (int64_t i = scan0; i < e1; ++i) {
        const uint8_t c = codes[i];
        if (c > 3 || (qual && qual[i] < thr)) {
            run = 0;
            fwd = 0;
            rc = 0;
            continue;
        }
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | (static_cast<uint64_t>(3 - c) << rc_shift);
        // run >= k already implies i >= e0: the run started at or after
        // scan0, so i >= scan0 + k - 1 >= e0 (and i >= k - 1 >= e0 when
        // scan0 clamped to 0) — no end-range check needed
        if (++run >= k) emit(fwd < rc ? fwd : rc);
    }
}

// Per-bucket LSD sort + RLE over the MSD-bucket span [d0, d1), emitting
// compacted (code, count) rows from starts[d0] upward in out_codes/
// out_counts. Inner = uint32_t stores only the low inner_bits (the bucket
// id carries the top 10; codes are reconstructed as (d << msd_shift) |
// inner), Inner = uint64_t stores the full key (the masked digit windows
// above inner_bits are constant within a bucket, so ordering is
// unaffected). Emit writes trail consumption (u <= elements consumed), so
// the region never collides with later buckets of its own span and spans
// are disjoint — safe under span-parallel execution. Returns the span's
// unique count.
template <typename Inner>
int64_t sort_rle_span(Inner* s1, Inner* s2, const int64_t* starts,
                      int64_t m_total, int64_t n_buckets, int64_t d0,
                      int64_t d1, int inner_bits, int msd_shift,
                      uint64_t* out_codes, uint64_t* out_counts) {
    const int passes = (inner_bits + 15) / 16;
    const int digit_bits = (inner_bits + passes - 1) / passes;
    const int64_t dig_buckets = int64_t{1} << digit_bits;
    const Inner dig_mask = static_cast<Inner>(dig_buckets - 1);
    std::vector<uint32_t> hist(dig_buckets);
    const int64_t emit0 = starts[d0];
    int64_t u_total = 0;
    constexpr bool kFullKeys = sizeof(Inner) == 8;
    for (int64_t d = d0; d < d1; ++d) {
        const int64_t lo = starts[d];
        const int64_t hi = (d + 1 < n_buckets) ? starts[d + 1] : m_total;
        const int64_t len = hi - lo;
        if (len <= 0) continue;
        Inner* s = s1 + lo;
        Inner* t = s2 + lo;
        if (len >= int64_t{0xFFFFFFFF}) {
            // one MSD bucket with >= 2^32 elements would wrap the u32
            // histogram prefix sums (conceivable only for genome-scale
            // low-complexity input): comparison-sort that bucket instead
            std::sort(s, s + len);
        } else if (len > 1) {
            for (int p = 0; p < passes; ++p) {
                const int shift = p * digit_bits;
                std::memset(hist.data(), 0, dig_buckets * sizeof(uint32_t));
                for (int64_t i = 0; i < len; ++i)
                    ++hist[(s[i] >> shift) & dig_mask];
                uint32_t acc = 0;
                for (int64_t j = 0; j < dig_buckets; ++j) {
                    const uint32_t c = hist[j];
                    hist[j] = acc;
                    acc += c;
                }
                for (int64_t i = 0; i < len; ++i)
                    t[hist[(s[i] >> shift) & dig_mask]++] = s[i];
                std::swap(s, t);
            }
        }
        const uint64_t top =
            kFullKeys ? 0 : (static_cast<uint64_t>(d) << msd_shift);
        Inner prev = s[0];
        uint64_t cnt = 1;
        for (int64_t j = 1; j < len; ++j) {
            const Inner v = s[j];
            if (v != prev) {
                out_codes[emit0 + u_total] = top | prev;
                out_counts[emit0 + u_total] = cnt;
                ++u_total;
                prev = v;
                cnt = 1;
            } else {
                ++cnt;
            }
        }
        out_codes[emit0 + u_total] = top | prev;
        out_counts[emit0 + u_total] = cnt;
        ++u_total;
    }
    return u_total;
}

// The radix counting engine for k >= 13 (k <= 12 takes the counting sort):
// range-parallel rolling emit into per-thread segments of out_codes, one
// 1024-way MSD scatter into leased scratch (per-thread disjoint cursors
// derived from per-thread histograms), span-parallel per-bucket LSD + RLE,
// and a left-compacting stitch of the span results. Single-threaded when
// the input is small or the host has one core — then the phases degrade to
// exactly the sequential pipeline. Inner picks the element width (u32 for
// k <= 21 — half the sort traffic; u64 above). Returns the unique count,
// or -1 with *m_out set when m < 2^20: the windows are left compacted in
// out_codes[0..m) for the caller's std::sort finish.
template <typename Inner>
int64_t count_radix(const uint8_t* codes, int64_t n, const uint8_t* qual,
                    int32_t thr, int k, uint64_t* out_codes,
                    uint64_t* out_counts, int64_t* m_out) {
    static constexpr int kMsdBits = 10;
    static constexpr int64_t kMsdBuckets = int64_t{1} << kMsdBits;
    const int inner_bits = 2 * k - kMsdBits;
    const int msd_shift = inner_bits;
    const uint64_t inner_mask =
        inner_bits >= 32 ? 0xFFFFFFFFULL : ((1ULL << inner_bits) - 1);

    const unsigned n_threads_roll =
        pick_threads(n, int64_t{1} << 21);
    // ranges of window END indices; each >= 4k bases or threads collapse
    const unsigned max_by_size =
        static_cast<unsigned>(n / std::max<int64_t>(4 * k, 4096) + 1);
    const unsigned T = std::max(1u, std::min(n_threads_roll, max_by_size));

    std::vector<int64_t> seg_base(T + 1);
    for (unsigned t = 0; t <= T; ++t)
        seg_base[t] = static_cast<int64_t>(n * (uint64_t)t / T);
    std::vector<int64_t> seg_m(T, 0);
    std::vector<std::vector<int64_t>> seg_hist(
        T, std::vector<int64_t>(kMsdBuckets, 0));

    auto roll_seg = [&](unsigned t) {
        int64_t mm = 0;
        uint64_t* dst = out_codes + seg_base[t];
        int64_t* hist = seg_hist[t].data();
        roll_range(codes, qual, thr, k, seg_base[t], seg_base[t + 1],
                   [&](uint64_t key) {
                       dst[mm++] = key;
                       ++hist[key >> msd_shift];
                   });
        seg_m[t] = mm;
    };
    if (T > 1) {
        std::vector<std::thread> ws;
        ws.reserve(T);
        for (unsigned t = 0; t < T; ++t) ws.emplace_back(roll_seg, t);
        for (auto& w : ws) w.join();
    } else {
        roll_seg(0);
    }
    int64_t m = 0;
    for (unsigned t = 0; t < T; ++t) m += seg_m[t];
    *m_out = m;
    if (m == 0) return 0;

    std::vector<int64_t> starts(kMsdBuckets);
    {
        int64_t sum = 0;
        for (int64_t b = 0; b < kMsdBuckets; ++b) {
            starts[b] = sum;
            for (unsigned t = 0; t < T; ++t) sum += seg_hist[t][b];
        }
    }

    auto compact_segments = [&]() {
        int64_t w = seg_m[0];
        for (unsigned t = 1; t < T; ++t) {
            std::memmove(out_codes + w, out_codes + seg_base[t],
                         seg_m[t] * sizeof(uint64_t));
            w += seg_m[t];
        }
    };
    if (m < (int64_t{1} << 20)) {
        if (T > 1) compact_segments();
        return -1;  // caller finishes with std::sort
    }

    ScratchLease lease(2 * m * static_cast<int64_t>(sizeof(Inner)));
    if (lease.get() == nullptr) {
        // scratch allocation failed: zero-extra-memory std::sort finish
        // (rare OOM path; correctness over speed)
        if (T > 1) compact_segments();
        *m_out = m;
        return -1;
    }
    Inner* s1 = static_cast<Inner*>(lease.get());
    Inner* s2 = s1 + m;

    // per-(thread, bucket) scatter cursors: column-prefix over seg_hist
    auto scatter_seg = [&](unsigned t, const int64_t* cursors) {
        const uint64_t* src = out_codes + seg_base[t];
        const int64_t mm = seg_m[t];
        std::vector<int64_t> cur(cursors, cursors + kMsdBuckets);
        for (int64_t i = 0; i < mm; ++i) {
            const uint64_t v = src[i];
            s1[cur[v >> msd_shift]++] =
                static_cast<Inner>(sizeof(Inner) == 8 ? v : (v & inner_mask));
        }
    };
    {
        std::vector<std::vector<int64_t>> offs(
            T, std::vector<int64_t>(kMsdBuckets));
        for (int64_t b = 0; b < kMsdBuckets; ++b) {
            int64_t acc = starts[b];
            for (unsigned t = 0; t < T; ++t) {
                offs[t][b] = acc;
                acc += seg_hist[t][b];
            }
        }
        if (T > 1) {
            std::vector<std::thread> ws;
            ws.reserve(T);
            for (unsigned t = 0; t < T; ++t)
                ws.emplace_back(scatter_seg, t, offs[t].data());
            for (auto& w : ws) w.join();
        } else {
            scatter_seg(0, offs[0].data());
        }
    }

    // span-parallel sort+RLE: split buckets into S contiguous spans of
    // roughly equal element volume
    const unsigned S = std::max(
        1u, std::min(pick_threads(m, int64_t{1} << 20),
                     static_cast<unsigned>(kMsdBuckets)));
    std::vector<int64_t> span_d0(S + 1, kMsdBuckets);
    span_d0[0] = 0;
    {
        int64_t acc = 0;
        unsigned s = 1;
        for (int64_t b = 0; b < kMsdBuckets && s < S; ++b) {
            const int64_t hi = (b + 1 < kMsdBuckets) ? starts[b + 1] : m;
            acc = hi;
            if (acc >= m * static_cast<int64_t>(s) / S) span_d0[s++] = b + 1;
        }
    }
    std::vector<int64_t> span_u(S, 0);
    auto run_span = [&](unsigned s) {
        if (span_d0[s] >= kMsdBuckets || span_d0[s] >= span_d0[s + 1]) {
            span_u[s] = 0;  // volume skew left this span empty
            return;
        }
        span_u[s] = sort_rle_span<Inner>(
            s1, s2, starts.data(), m, kMsdBuckets, span_d0[s], span_d0[s + 1],
            inner_bits, msd_shift, out_codes, out_counts);
    };
    if (S > 1) {
        std::vector<std::thread> ws;
        ws.reserve(S);
        for (unsigned s = 0; s < S; ++s) ws.emplace_back(run_span, s);
        for (auto& w : ws) w.join();
    } else {
        run_span(0);
    }

    // stitch: left-compact span results (dest cum <= span emit base since
    // unique <= elements for every earlier span)
    int64_t u_total = span_u[0];
    for (unsigned s = 1; s < S; ++s) {
        if (span_u[s] <= 0) continue;
        const int64_t src = starts[span_d0[s]];
        if (src != u_total) {
            std::memmove(out_codes + u_total, out_codes + src,
                         span_u[s] * sizeof(uint64_t));
            std::memmove(out_counts + u_total, out_counts + src,
                         span_u[s] * sizeof(uint64_t));
        }
        u_total += span_u[s];
    }
    return u_total;
}

}  // namespace

extern "C" {

// Eagerly fault in a caller-allocated buffer (see populate_write above):
// the Python side calls this on fresh numpy scratch so genome-scale output
// buffers don't pay lazy per-page fault costs during the count.
void krust_populate_write(uint8_t* ptr, int64_t n_bytes) {
    populate_write(ptr, n_bytes);
}

// Host counting core: rolling canonical codes -> sort -> RLE, in one call.
// The sort-based design mirrors the device engine (sorting IS the reduction
// primitive there; see ops/table.py) rather than the reference's concurrent
// hash map (reference: src/run.rs:489-583) — on a host it also wins: the
// rolling emit is ~5 ns/base and the sort dominates, beating per-window
// hash updates and allocations. Large inputs ride an LSD radix sort over
// the 2k key bits (O(m) passes instead of comparison n·log n — measured
// ~4x std::sort at 29M keys on this host); small ones keep std::sort.
// Serves machines without an accelerator and the bench's CPU fallback.
// k-dispatch: k<=12 counting sort (4^k histogram IS the count vector);
// 13<=k<=21 u32 inner-sort (count_radix<uint32_t>, ~1.35x the u64 path);
// k>=22 MSD+LSD u64 radix (count_radix<uint64_t>); tiny inputs std::sort.
// The radix engine range-parallelizes over KRUST_NATIVE_THREADS /
// hardware_concurrency cores ((k-1)-halo roll ranges, per-thread scatter
// cursors, bucket-span sorts — bit-identical to the sequential pipeline).
//   codes/n:   input stream of 0..4 codes (4 = separator/invalid)
//   qual/thr:  optional aligned quality bytes; bases with qual < thr are
//              invalid (thr -1: off)
//   k:         1..=32
//   out_codes: caller buffer, capacity n u64 entries (thread roll segments
//              are end-index addressed); returns the sorted unique
//              canonical codes in its prefix
//   out_counts: caller buffer, same capacity; per-unique counts
// Returns the number of unique canonical k-mers (0 when no window fits).
int64_t krust_count_stream(const uint8_t* codes, int64_t n, const uint8_t* qual,
                           int32_t thr, int32_t k, uint64_t* out_codes,
                           uint64_t* out_counts) {
    if (k < 1 || k > 32 || n < k) return 0;
    if (k <= 12 && n >= (int64_t{1} << 16) &&
        n >= (int64_t{1} << (2 * k)) / 16) {
        // Counting sort: the code space (4^k <= 16M) fits a host histogram,
        // which doubles as the count vector — no materialized window array,
        // no sort, one sequential scan to emit the nonzero entries sorted.
        // Gated on n >= 4^k/16 so a modest input doesn't pay a 134 MB
        // (k=12) histogram sweep; smaller inputs take the radix/std::sort
        // path below (safe for k >= 6; k <= 5 always passes this gate
        // when n >= 2^16 since 4^5/16 = 64).
        std::vector<uint64_t> hist(uint64_t{1} << (2 * k));
        roll_range(codes, qual, thr, k, 0, n,
                   [&](uint64_t key) { ++hist[key]; });
        int64_t u = 0;
        for (uint64_t code = 0; code < hist.size(); ++code) {
            if (hist[code]) {
                out_codes[u] = code;
                out_counts[u] = hist[code];
                ++u;
            }
        }
        return u;
    }
    int64_t m = 0;
    if (n >= (int64_t{1} << 16)) {
        const int64_t u =
            k <= 21 ? count_radix<uint32_t>(codes, n, qual, thr, k, out_codes,
                                            out_counts, &m)
                    : count_radix<uint64_t>(codes, n, qual, thr, k, out_codes,
                                            out_counts, &m);
        if (u >= 0) return u;
        // m < 2^20: windows sit compacted in out_codes[0..m); sort finish
        std::sort(out_codes, out_codes + m);
    } else {
        roll_range(codes, qual, thr, k, 0, n,
                   [&](uint64_t key) { out_codes[m++] = key; });
        if (m == 0) return 0;
        std::sort(out_codes, out_codes + m);
    }
    // RLE into the output prefixes: every write lands at index u <= j-1
    // strictly behind the read cursor j, so the compaction is forward-safe.
    int64_t u = 0;
    uint64_t prev = out_codes[0];
    uint64_t cnt = 1;
    for (int64_t j = 1; j < m; ++j) {
        const uint64_t v = out_codes[j];
        if (v != prev) {
            out_codes[u] = prev;
            out_counts[u] = cnt;
            ++u;
            prev = v;
            cnt = 1;
        } else {
            ++cnt;
        }
    }
    out_codes[u] = prev;
    out_counts[u] = cnt;
    return u + 1;
}

}  // extern "C"
