// Native host-side setup kernels (C++), loaded via ctypes.
//
// The runtime around the device compute path: sparsity-pattern construction
// and scatter-add assembly are the host-setup hot spots at 1M+ DoF
// (np.unique sorts and np.add.at scatters are single-threaded Python/numpy
// paths an order of magnitude slower). These replace the load-bearing
// parts of EllPattern.build (la/ell.py) and the host static assembly of
// the P1 fast path — the role DOLFINx's C++ core plays for the reference's
// setup stage (SURVEY.md §2.2).
//
// Build: make -C proximalgalerkin_torch/native
// Fallback: pure-numpy paths remain when the shared object is absent.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sort-and-dedup of 64-bit keys (row * ncols + col), producing the sorted
// unique key array and the slot (inverse) index of every input entry.
// Returns the number of unique keys.
int64_t build_pattern(const int64_t* keys, int64_t n,
                      int64_t* uniq_out,     // size >= n
                      int64_t* slot_out) {   // size n
    // sort (key, index) pairs by value — cache-friendly, branch-predictable
    std::vector<std::pair<int64_t, int64_t>> kv(n);
    for (int64_t i = 0; i < n; ++i) kv[i] = {keys[i], i};
    std::sort(kv.begin(), kv.end());
    int64_t nuniq = 0;
    int64_t prev = INT64_MIN;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t k = kv[i].first;
        if (k != prev) {
            uniq_out[nuniq++] = k;
            prev = k;
        }
        slot_out[kv[i].second] = nuniq - 1;
    }
    return nuniq;
}

// out[slots[i]] += vals[i]  (the np.add.at replacement)
void scatter_add(const double* vals, const int64_t* slots, int64_t n,
                 double* out) {
    for (int64_t i = 0; i < n; ++i) out[slots[i]] += vals[i];
}

// Count entries per row given sorted unique keys; rows = key / ncols.
void row_counts(const int64_t* uniq, int64_t nuniq, int64_t ncols,
                int64_t* counts /* size nrows, zero-initialized */) {
    for (int64_t i = 0; i < nuniq; ++i) counts[uniq[i] / ncols] += 1;
}

}  // extern "C"
