// Greedy radius downsampling (the DTU eval protocol's point thinning,
// reference evals/eval_dtu.py:100-116): iterate points in order; keep
// a point iff no already-KEPT point lies within `radius`.
//
// Equivalence with the reference loop: the reference suppresses every
// neighbor of each kept point and then re-marks the kept point, so a
// point survives exactly when no earlier kept point is within radius —
// which is what this loop tests directly. Only KEPT points ever need
// to be queried, so a uniform grid with cell size = radius bounds the
// search to the 27 neighboring cells. Distances are computed in double
// on float64 coordinates (the caller promotes, exactly like scipy's
// cKDTree), with the same inclusive boundary (d <= r).
//
// Storage is a flat open-addressed hash table with fixed-capacity
// cells: kept points are pairwise farther than `radius` apart, so an
// r-sided cell can hold only a handful of them (strict-> r packing in
// an r-cube tops out below 8); a tiny overflow list catches the
// theoretical spill without a per-cell heap allocation.
//
// Single-threaded on purpose: the greedy recurrence is order-dependent
// (point i's fate depends on which earlier points were kept).
//
// A copy of s_volsdf_tpu/native/downsample.cpp (host code: the
// recurrence is sequential). Built at first use by
// engine/eval_geo.py: g++ -O3 -shared -fPIC -> _build/libdownsample.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr int kCellCap = 7;        // kept points per cell (see header)
constexpr uint64_t kEmpty = ~0ull;

struct Cell {
    int32_t n;
    int32_t idx[kCellCap];
};

inline uint64_t cell_key(int64_t cx, int64_t cy, int64_t cz) {
    // pack three 21-bit signed cell coords (covers +/-1e6 cells)
    const uint64_t M = (1ull << 21) - 1;
    return ((static_cast<uint64_t>(cx) & M) << 42)
         | ((static_cast<uint64_t>(cy) & M) << 21)
         |  (static_cast<uint64_t>(cz) & M);
}

inline uint64_t mix(uint64_t k) {   // splitmix64 finalizer
    k += 0x9e3779b97f4a7c15ull;
    k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ull;
    k = (k ^ (k >> 27)) * 0x94d049bb133111ebull;
    return k ^ (k >> 31);
}

}  // namespace

extern "C" void radius_downsample(const double* pts, int64_t n,
                                  double radius, uint8_t* keep) {
    const double r2 = radius * radius;
    const double inv = 1.0 / radius;

    // Open-addressed table, keys split from payload so probe walks
    // stream through a compact 8 B/slot array (the 40 B payload is
    // only touched on a key match). Only kept points insert cells, so
    // occupancy <= n and load factor <= 0.5 at cap = 2n.
    uint64_t cap = 64;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    std::vector<uint64_t> keys(cap, kEmpty);
    // payload deliberately uninitialized: .n is set on first insert
    std::unique_ptr<Cell[]> cells(new Cell[cap]);
    std::vector<int32_t> overflow;  // indices of kept spill points

    for (int64_t i = 0; i < n; ++i) {
        const double x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
        const int64_t cx = static_cast<int64_t>(std::floor(x * inv));
        const int64_t cy = static_cast<int64_t>(std::floor(y * inv));
        const int64_t cz = static_cast<int64_t>(std::floor(z * inv));
        bool suppressed = false;
        for (int64_t dx = -1; dx <= 1 && !suppressed; ++dx)
            for (int64_t dy = -1; dy <= 1 && !suppressed; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    const uint64_t key = cell_key(cx + dx, cy + dy,
                                                  cz + dz);
                    uint64_t slot = mix(key) & mask;
                    while (keys[slot] != kEmpty) {
                        if (keys[slot] == key) {
                            const Cell& c = cells[slot];
                            for (int32_t t = 0; t < c.n; ++t) {
                                const int32_t j = c.idx[t];
                                const double ddx = x - pts[3 * j];
                                const double ddy = y - pts[3 * j + 1];
                                const double ddz = z - pts[3 * j + 2];
                                if (ddx * ddx + ddy * ddy + ddz * ddz
                                        <= r2) {
                                    suppressed = true;
                                    break;
                                }
                            }
                            break;
                        }
                        slot = (slot + 1) & mask;
                    }
                    if (suppressed) break;
                }
        // brute-force the (normally empty) overflow list
        for (size_t t = 0; t < overflow.size() && !suppressed; ++t) {
            const int32_t j = overflow[t];
            const double ddx = x - pts[3 * j];
            const double ddy = y - pts[3 * j + 1];
            const double ddz = z - pts[3 * j + 2];
            if (ddx * ddx + ddy * ddy + ddz * ddz <= r2)
                suppressed = true;
        }
        keep[i] = suppressed ? 0 : 1;
        if (suppressed) continue;

        const uint64_t key = cell_key(cx, cy, cz);
        uint64_t slot = mix(key) & mask;
        while (keys[slot] != kEmpty && keys[slot] != key)
            slot = (slot + 1) & mask;
        if (keys[slot] == kEmpty) { keys[slot] = key; cells[slot].n = 0; }
        Cell& c = cells[slot];
        if (c.n < kCellCap)
            c.idx[c.n++] = static_cast<int32_t>(i);
        else
            overflow.push_back(static_cast<int32_t>(i));
    }
}
