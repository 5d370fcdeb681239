// Native core of the symbolic plan builder (the framework's
// "graph builder"): the hot index-plan primitives that the host runs
// once per problem structure.  The reference's equivalent layer
// (HYMLS_HierarchicalMap.cpp, HYMLS_MatrixBlock.cpp block extraction,
// FECrsMatrix pattern assembly) is C++; so is this one.
//
// Exposed via a plain C ABI consumed with ctypes (pybind11 is not
// available in this toolchain); every entry point has a numpy
// fallback in core/plan.py.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) split across hardware threads.
// Query batches reach ~1e8 elements on 32^3 skew problems; the
// binary-search loops are embarrassingly parallel.
template <typename F>
void parallel_for(int64_t n, F fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t n_threads = std::min<int64_t>(hw ? hw : 1, 16);
    if (n < (1 << 16) || n_threads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Batched sorted lookup: for each query q[i], find its position in the
// ascending array keys[0..n_keys) or return `miss` when absent.
// (CsrLookup.query: the plan builder issues millions of these.)
void lookup_sorted_i64(const int64_t* keys, int64_t n_keys,
                       const int64_t* q, int64_t n_q,
                       int64_t miss, int64_t* out) {
    const int64_t* end = keys + n_keys;
    parallel_for(n_q, [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t* it = std::lower_bound(keys, end, q[i]);
            out[i] = (it != end && *it == q[i]) ? (it - keys) : miss;
        }
    });
}

// Gather-form inversion of a scatter: for each target t in
// [0, n_targets), collect the (padded) list of source ids s with
// targets[s] == t.  Returns the required width; call once with
// out == nullptr to size the output, then again to fill it
// (row-major (n_targets, width), padded with `sentinel`).
// (_invert_to_padded: TPU scatters serialize, padded gathers do not.)
int64_t invert_to_padded_i64(const int64_t* targets, const int64_t* srcs,
                             int64_t n, int64_t n_targets,
                             int64_t sentinel, int64_t width,
                             int64_t* out) {
    // counting pass
    int64_t* counts = new int64_t[n_targets]();
    for (int64_t i = 0; i < n; ++i) counts[targets[i]] += 1;
    int64_t max_c = 1;
    for (int64_t t = 0; t < n_targets; ++t)
        if (counts[t] > max_c) max_c = counts[t];
    if (out == nullptr) { delete[] counts; return max_c; }

    parallel_for(n_targets * width, [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) out[i] = sentinel;
    });
    std::memset(counts, 0, sizeof(int64_t) * n_targets);
    for (int64_t i = 0; i < n; ++i) {
        int64_t t = targets[i];
        out[t * width + counts[t]] = srcs[i];
        counts[t] += 1;
    }
    delete[] counts;
    return max_c;
}

// Positions of each gid in an ascending array (every gid present);
// the _locate primitive of the plan builder.
void locate_sorted_i64(const int64_t* sorted, int64_t n_sorted,
                       const int64_t* gids, int64_t n_gids,
                       int64_t* out) {
    const int64_t* end = sorted + n_sorted;
    parallel_for(n_gids, [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            out[i] = std::lower_bound(sorted, end, gids[i]) - sorted;
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hash-indexed CSR-entry lookup.
//
// The padded block-gather plans issue ~1e8 (row, col) -> entry-id
// queries per level on 32^3-skew problems; a binary search over the
// sorted key array costs ~20 dependent cache misses per query and the
// build host has ONE core.  An open-addressing hash (linear probing,
// 2x slack, 16-byte key+value slots) brings that to ~1 miss, and an
// explicit software-prefetch pipeline overlaps several misses.
// ---------------------------------------------------------------------------

namespace {

struct CsrHash {
    uint64_t mask = 0;            // table size - 1 (power of two)
    int64_t* kv = nullptr;        // interleaved [key, val] slots
};

inline uint64_t hash_mix(uint64_t x) {
    x *= 0x9E3779B97F4A7C15ull;
    x ^= x >> 32;
    return x;
}

inline int64_t hash_find(const CsrHash* h, int64_t key, int64_t miss) {
    uint64_t s = hash_mix(static_cast<uint64_t>(key)) & h->mask;
    for (;;) {
        int64_t k = h->kv[2 * s];
        if (k == key) return h->kv[2 * s + 1];
        if (k == -1) return miss;
        s = (s + 1) & h->mask;
    }
}

}  // namespace

extern "C" {

// Build a hash over ascending non-negative keys; value = position.
void* csr_hash_build_i64(const int64_t* keys, int64_t n_keys) {
    auto* h = new CsrHash;
    uint64_t size = 16;
    while (size < static_cast<uint64_t>(2 * n_keys + 1)) size <<= 1;
    h->mask = size - 1;
    h->kv = new int64_t[2 * size];
    for (uint64_t i = 0; i < size; ++i) {
        h->kv[2 * i] = -1;
        h->kv[2 * i + 1] = 0;
    }
    for (int64_t i = 0; i < n_keys; ++i) {
        uint64_t s = hash_mix(static_cast<uint64_t>(keys[i])) & h->mask;
        while (h->kv[2 * s] != -1) s = (s + 1) & h->mask;
        h->kv[2 * s] = keys[i];
        h->kv[2 * s + 1] = i;
    }
    return h;
}

void csr_hash_free_i64(void* handle) {
    auto* h = static_cast<CsrHash*>(handle);
    delete[] h->kv;
    delete h;
}

// Flat lookup: out[i] = position of q[i], or miss.
void csr_hash_lookup_i64(void* handle, const int64_t* q, int64_t n_q,
                         int64_t miss, int64_t* out) {
    auto* h = static_cast<CsrHash*>(handle);
    constexpr int64_t D = 16;       // prefetch distance
    for (int64_t i = 0; i < n_q; ++i) {
        if (i + D < n_q) {
            uint64_t s = hash_mix(static_cast<uint64_t>(q[i + D])) & h->mask;
            __builtin_prefetch(&h->kv[2 * s]);
        }
        out[i] = hash_find(h, q[i], miss);
    }
}

// Block lookup: out[b, i, j] = position of rows[b, i]*stride +
// cols[b, j] (the padded A11/A12/A21/A22 gather plans), computed
// in-register — the (B, nr, nc) broadcast key array is never
// materialized on the Python side.  Padded slots carry out-of-range
// ids (row >= row_limit / col >= col_limit): they are guaranteed
// misses and are filled without probing — the pad fraction of these
// plans is large (ragged group sizes padded to the max), and skipping
// it cuts the probe volume severalfold.
void csr_hash_block_i64(void* handle, const int64_t* rows,
                        const int64_t* cols, int64_t B, int64_t nr,
                        int64_t nc, int64_t stride, int64_t row_limit,
                        int64_t col_limit, int64_t miss, int64_t* out) {
    auto* h = static_cast<CsrHash*>(handle);
    constexpr int64_t D = 16;       // prefetch distance
    for (int64_t b = 0; b < B; ++b) {
        const int64_t* rb = rows + b * nr;
        const int64_t* cb = cols + b * nc;
        int64_t* ob = out + b * nr * nc;
        for (int64_t i = 0; i < nr; ++i) {
            int64_t* oi = ob + i * nc;
            if (rb[i] >= row_limit) {
                for (int64_t j = 0; j < nc; ++j) oi[j] = miss;
                continue;
            }
            int64_t base = rb[i] * stride;
            for (int64_t j = 0; j < nc; ++j) {
                if (cb[j] >= col_limit) { oi[j] = miss; continue; }
                if (j + D < nc) {
                    uint64_t s = hash_mix(
                        static_cast<uint64_t>(base + cb[j + D])) & h->mask;
                    __builtin_prefetch(&h->kv[2 * s]);
                }
                oi[j] = hash_find(h, base + cb[j], miss);
            }
        }
    }
}

}  // extern "C"
