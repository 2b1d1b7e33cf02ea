// Native BVH builder: binned SAH -> flat DFS arrays with skip links.
//
// TPU-native analog of the reference's host-side BVH construction
// (reference: CudaRayTracer/src/Hittables/Hittable.cuh:303-385, which sorts
// by primitive TYPE via thrust and allocates managed-memory node pairs).
// This builder is a proper surface-area-heuristic build producing the flat
// skip-link layout consumed by ops/bvh_traverse.py and is the hot host path
// during interactive editing (the reference rebuilds its BVH on every
// geometry drag, CudaLayer.cpp:491-556) — hence C++ rather than NumPy.
//
// C ABI (ctypes):
//   int crt_bvh_build(const float* bmin, const float* bmax,
//                     const int* prim_ids, int n,
//                     float* node_min, float* node_max,
//                     int* node_prim, int* node_skip);
// Inputs:  bmin/bmax [n,3] row-major primitive AABBs, prim_ids [n].
// Outputs: caller-allocated arrays of capacity (2n-1): node AABBs, leaf
//          primitive id (or -1 for interior), and DFS skip link (-1 = end).
// Returns the node count, or -1 on error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    Vec3 lo{3e38f, 3e38f, 3e38f};
    Vec3 hi{-3e38f, -3e38f, -3e38f};
    void grow(const Box& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float half_area() const {
        float dx = std::max(0.f, hi.x - lo.x);
        float dy = std::max(0.f, hi.y - lo.y);
        float dz = std::max(0.f, hi.z - lo.z);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    static constexpr int kBins = 16;
    const float* bmin;
    const float* bmax;
    const int* prim_ids;
    std::vector<Vec3> centroid;
    std::vector<Box> box;
    std::vector<int> order;  // permutation being partitioned

    std::vector<float> out_min, out_max;
    std::vector<int> out_prim;

    int emit(const Box& b, int prim) {
        out_min.insert(out_min.end(), {b.lo.x, b.lo.y, b.lo.z});
        out_max.insert(out_max.end(), {b.hi.x, b.hi.y, b.hi.z});
        out_prim.push_back(prim);
        return (int)out_prim.size() - 1;
    }

    // Build [lo, hi) of `order`; emits nodes in DFS order.
    void build(int lo, int hi) {
        Box bounds;
        Box cbounds;
        for (int i = lo; i < hi; ++i) {
            bounds.grow(box[order[i]]);
            cbounds.grow(centroid[order[i]]);
        }
        int count = hi - lo;
        if (count == 1) {
            emit(bounds, prim_ids[order[lo]]);
            return;
        }

        // choose split: binned SAH over the widest centroid axis
        float ext[3] = {cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                        cbounds.hi.z - cbounds.lo.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] <= 1e-12f) {
            mid = lo + count / 2;  // degenerate: median split
        } else {
            float c0 = (&cbounds.lo.x)[axis];
            float scale = kBins / ext[axis];
            Box bin_box[kBins];
            int bin_cnt[kBins] = {0};
            for (int i = lo; i < hi; ++i) {
                float c = (&centroid[order[i]].x)[axis];
                int b = std::min(kBins - 1, (int)((c - c0) * scale));
                bin_box[b].grow(box[order[i]]);
                bin_cnt[b]++;
            }
            // sweep for the cheapest partition
            float right_area[kBins];
            Box acc;
            int right_cnt[kBins];
            int rc = 0;
            for (int b = kBins - 1; b >= 1; --b) {
                acc.grow(bin_box[b]);
                rc += bin_cnt[b];
                right_area[b] = acc.half_area();
                right_cnt[b] = rc;
            }
            float best_cost = 3e38f;
            int best_bin = -1;
            Box lacc;
            int lc = 0;
            for (int b = 0; b < kBins - 1; ++b) {
                lacc.grow(bin_box[b]);
                lc += bin_cnt[b];
                if (lc == 0 || right_cnt[b + 1] == 0) continue;
                float cost =
                    lacc.half_area() * lc + right_area[b + 1] * right_cnt[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_bin = b;
                }
            }
            if (best_bin < 0) {
                mid = lo + count / 2;
                std::nth_element(
                    order.begin() + lo, order.begin() + mid, order.begin() + hi,
                    [&](int a, int b) {
                        return (&centroid[a].x)[axis] < (&centroid[b].x)[axis];
                    });
            } else {
                float split = c0 + (best_bin + 1) / scale;
                auto it = std::partition(
                    order.begin() + lo, order.begin() + hi,
                    [&](int i) { return (&centroid[i].x)[axis] < split; });
                mid = (int)(it - order.begin());
                if (mid == lo || mid == hi) mid = lo + count / 2;  // safety
            }
        }
        emit(bounds, -1);
        build(lo, mid);
        build(mid, hi);
    }
};

}  // namespace

extern "C" int crt_bvh_build(const float* bmin, const float* bmax,
                             const int* prim_ids, int n, float* node_min,
                             float* node_max, int* node_prim, int* node_skip) {
    if (n <= 0) return 0;
    Builder b;
    b.bmin = bmin;
    b.bmax = bmax;
    b.prim_ids = prim_ids;
    b.centroid.resize(n);
    b.box.resize(n);
    b.order.resize(n);
    for (int i = 0; i < n; ++i) {
        Vec3 lo{bmin[3 * i], bmin[3 * i + 1], bmin[3 * i + 2]};
        Vec3 hi{bmax[3 * i], bmax[3 * i + 1], bmax[3 * i + 2]};
        b.box[i] = Box{lo, hi};
        b.centroid[i] = {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f,
                         (lo.z + hi.z) * 0.5f};
        b.order[i] = i;
    }
    b.out_min.reserve(6 * n);
    b.out_max.reserve(6 * n);
    b.out_prim.reserve(2 * n);
    b.build(0, n);

    int m = (int)b.out_prim.size();
    if (m != 2 * n - 1) return -1;
    std::memcpy(node_min, b.out_min.data(), sizeof(float) * 3 * m);
    std::memcpy(node_max, b.out_max.data(), sizeof(float) * 3 * m);
    std::memcpy(node_prim, b.out_prim.data(), sizeof(int) * m);

    // skip links from subtree sizes (DFS order): reverse stack walk
    std::vector<int64_t> size(m, 1);
    std::vector<int64_t> stack;
    stack.reserve(m);
    for (int i = m - 1; i >= 0; --i) {
        if (node_prim[i] >= 0) {
            stack.push_back(1);
        } else {
            int64_t l = stack.back();
            stack.pop_back();
            int64_t r = stack.back();
            stack.pop_back();
            size[i] = 1 + l + r;
            stack.push_back(size[i]);
        }
    }
    for (int i = 0; i < m; ++i) {
        int64_t s = i + size[i];
        node_skip[i] = s >= m ? -1 : (int)s;
    }
    return m;
}
