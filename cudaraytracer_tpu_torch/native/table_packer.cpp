// Native scene-table packer: the host-side "scene compiler" that turns the
// SoA scene into the Pallas megakernel's packed search/payload/cluster
// tables (the analog of the reference's host scene build + BVH construction,
// CudaRayTracer/src/Cuda/CudaLayer.cpp:103-362 + Hittables/Hittable.cuh:303).
//
// Must produce BIT-IDENTICAL output to the NumPy packer in
// ops/pallas/render_kernel.py::_pack_scene_tables_numpy — an equivalence
// test enforces this.  Runs on every interactive scene edit, so it is a
// latency-sensitive runtime component.
//
// Build: python -m cudaraytracer_tpu.native.build  (part of libcrt_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float BIG = 3.0e38f;

inline uint64_t spread3(uint64_t v) {
    v = (v | (v << 16)) & 0x30000FFull;
    v = (v | (v << 8)) & 0x300F00Full;
    v = (v | (v << 4)) & 0x30C30C3ull;
    v = (v | (v << 2)) & 0x9249249ull;
    return v;
}

inline uint64_t morton3(float x, float y, float z) {
    auto q = [](float v) -> uint64_t {
        long long t = (long long)(v * 1024.0f);  // trunc, like numpy astype
        if (t < 0) t = 0;
        if (t > 1023) t = 1023;
        return (uint64_t)t;
    };
    return (spread3(q(x)) << 2) | (spread3(q(y)) << 1) | spread3(q(z));
}

// median over f32 values (np.median of a float32 array stays float32)
float median_f32(std::vector<float> v) {
    if (v.empty()) return 0.0f;
    size_t m = v.size() / 2;
    std::nth_element(v.begin(), v.begin() + m, v.end());
    float hi = v[m];
    if (v.size() % 2) return hi;
    std::nth_element(v.begin(), v.begin() + m - 1, v.begin() + m);
    float lo = v[m - 1];
    return 0.5f * (lo + hi);
}

inline float pack_rgb(const float* a) {
    auto q = [](float c) -> long {
        float s = std::nearbyintf(c * 255.0f);  // rint, banker's rounding
        if (s < 0.0f) s = 0.0f;
        if (s > 255.0f) s = 255.0f;
        return (long)s;
    };
    return (float)(q(a[0]) * 65536 + q(a[1]) * 256 + q(a[2]));
}

// S-table row indices (render_kernel.py)
enum { S_CX, S_CY, S_CZ, S_R2, S_PTYPE, S_KAX, S_CK, S_CA, S_CB,
       S_HA, S_HB, S_AAX, S_BAX, S_ROWS_USED };
constexpr int S_ROWS = 16;  // rows 13-15 = triangle e2 (spare otherwise)
// Triangle columns overlay the rect rows (see render_kernel.py):
// CK/CA/CB = e1, KAX/AAX/BAX = n2 = e1 x e2, rows 13-15 = e2.
// Triangle-column row overlay (Havel-Herout precomputed planes, see
// render_kernel.py tables comment): N = e1 x e2; n1/m2 = barycentric
// plane normals; d_n/d1/d2 = plane offsets.
enum { S_NX = S_KAX, S_NY = S_AAX, S_NZ = S_BAX,
       S_N1X = S_CX, S_N1Y = S_CY, S_N1Z = S_CZ,
       S_M2X = S_CK, S_M2Y = S_CA, S_M2Z = S_CB,
       S_DN = 13, S_D1 = 14, S_D2 = 15 };
// P-table row indices
enum { P_CX, P_CY, P_CZ, P_MPARAM, P_PACKA, P_PACKB, P_PACKC, P_HA, P_HB };

}  // namespace

// Table-layout ABI version; pack_native.available() refuses a stale .so
// whose PACKC bit layout / segment order predates the Python packer's.
extern "C" int crt_pack_abi_version() { return 4; }

namespace {
// 8:8:8 quantized unit normal (render_kernel.py P-table comment); f32 op
// order matches the numpy packer EXACTLY (floor((n*0.5+0.5)*255+0.5)).
// All-zero input (flat triangle) packs the 0.0 sentinel.
inline float pack_vn(const float* vn) {
    if (vn[0] == 0.0f && vn[1] == 0.0f && vn[2] == 0.0f) return 0.0f;
    long q[3];
    for (int k = 0; k < 3; ++k) {
        float t = (vn[k] * 0.5f + 0.5f) * 255.0f + 0.5f;
        q[k] = (long)std::floor(t);
    }
    return (float)(q[0] * 65536 + q[1] * 256 + q[2]);
}
}  // namespace

extern "C" int crt_pack_tables(
    const float* center,   // [n,3] active prims, scene order (tri: v0)
    const float* size,     // [n,2]
    const float* edge1,    // [n,3] triangle v1-v0 (zeros elsewhere)
    const float* edge2,    // [n,3] triangle v2-v0
    const int* ptype,      // [n] 0 sphere, 1 xy, 2 xz, 3 yz, 4 triangle
    const int* mtype,      // [n]
    const float* mparam,   // [n] fuzz|ior|light by material (precomputed)
    const int* textype,    // [n]
    const int* texid,      // [n]
    const float* albedo,   // [n,3] effective (atlas mean already applied)
    const float* albedo2,  // [n,3]
    const float* bmin,     // [n,3] primitive AABBs
    const float* bmax,     // [n,3]
    const float* uv0,      // [n,2] per-vertex texcoords (vattrs; else null)
    const float* uv1,      // [n,2]
    const float* uv2,      // [n,2]
    const float* vn0,      // [n,3] per-vertex normals (vattrs; else null)
    const float* vn1,      // [n,3]
    const float* vn2,      // [n,3]
    int with_uv, int with_vattrs,
    int n, int npad, int cluster, int nsuper_clusters, int p_rows,
    float* S,              // [16, npad] out
    float* P,              // [p_rows, npad] out
    float* clus,           // [7, npad/cluster] out
    float* supers,         // [6, npad/span] out
    const int* slot_ids,   // [n] packed row -> scene slot
    int* prim_map,         // [npad] out
    int* out_n_super) {    // [1] out
    const int span = cluster * nsuper_clusters;
    if (npad % span || n > npad || cluster % 4) return -1;
    const int nc = npad / cluster;
    const int nsc = npad / span;

    // ---- default init (pad columns can never hit) ----
    std::memset(S, 0, sizeof(float) * S_ROWS * npad);
    std::memset(P, 0, sizeof(float) * p_rows * npad);
    for (int j = 0; j < npad; ++j) {
        S[S_R2 * npad + j] = -1.0f;
        S[S_HA * npad + j] = -1.0f;
        S[S_HB * npad + j] = -1.0f;
        prim_map[j] = -1;
    }
    // degenerate point boxes at +BIG: the strict tfar > tnear slab test
    // rejects them for every ray (an inverted box would be re-sorted by
    // the per-axis min/max and PASS, wasting full prim loops per wave)
    for (int c = 0; c < nc; ++c) {
        for (int k = 0; k < 6; ++k) clus[k * nc + c] = BIG;
        clus[6 * nc + c] = 0.0f;
    }
    for (int s2 = 0; s2 < nsc; ++s2)
        for (int k = 0; k < 6; ++k) supers[k * nsc + s2] = BIG;
    *out_n_super = 1;
    if (n == 0) return 0;

    // ---- Morton codes over normalized AABB centroids ----
    std::vector<float> cent(3 * n);
    float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) {
            float c = 0.5f * (bmin[i * 3 + k] + bmax[i * 3 + k]);
            cent[i * 3 + k] = c;
            cmin[k] = std::min(cmin[k], c);
            cmax[k] = std::max(cmax[k], c);
        }
    float ext[3];
    for (int k = 0; k < 3; ++k) {
        float e = cmax[k] - cmin[k];
        ext[k] = e > 0.0f ? e : 1.0f;
    }
    std::vector<uint64_t> code(n);
    for (int i = 0; i < n; ++i)
        code[i] = morton3((cent[i * 3 + 0] - cmin[0]) / ext[0],
                          (cent[i * 3 + 1] - cmin[1]) / ext[1],
                          (cent[i * 3 + 2] - cmin[2]) / ext[2]);
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return code[a] < code[b]; });

    // ---- segment: BIG first, then spheres, then rects (CLUSTER-aligned) --
    std::vector<float> area(n);
    for (int i = 0; i < n; ++i) {
        float dx = bmax[i * 3 + 0] - bmin[i * 3 + 0];
        float dy = bmax[i * 3 + 1] - bmin[i * 3 + 1];
        float dz = bmax[i * 3 + 2] - bmin[i * 3 + 2];
        area[i] = dx * dy + dy * dz + dz * dx;
    }
    float thresh = 50.0f * median_f32(area);
    std::vector<int> cols;  // row index in [0,n) or -1 alignment padding
    cols.reserve(npad);
    for (int seg = 0; seg < 4; ++seg) {
        for (int oi = 0; oi < n; ++oi) {
            int i = order[oi];
            bool big = area[i] > thresh;
            bool tri = ptype[i] == 4;
            bool rect = ptype[i] != 0 && !tri;
            bool take = seg == 0 ? big
                      : seg == 1 ? (!big && !rect && !tri)
                      : seg == 2 ? (!big && rect)
                                 : (!big && tri);
            if (take) cols.push_back(i);
        }
        while (cols.size() % cluster) cols.push_back(-1);
    }
    const int ncols = (int)cols.size();
    if (ncols > npad) return -2;

    static const int K_AX[5] = {0, 2, 1, 0, 0};
    static const int A_AX[5] = {0, 0, 0, 1, 0};
    static const int B_AX[5] = {0, 1, 2, 2, 0};
    static const int EA[5] = {0, 0, 0, 1, 0};

    for (int j = 0; j < ncols; ++j) {
        int i = cols[j];
        if (i < 0) continue;
        int t = ptype[i];
        const float* c = &center[i * 3];
        float r = size[i * 2 + 0];
        float ha = 0.5f * (EA[t] == 0 ? size[i * 2 + 0] : size[i * 2 + 1]);
        float hb = 0.5f * (EA[t] == 0 ? size[i * 2 + 1] : size[i * 2 + 0]);
        S[S_CX * npad + j] = c[0];
        S[S_CY * npad + j] = c[1];
        S[S_CZ * npad + j] = c[2];
        S[S_R2 * npad + j] = r * r;
        S[S_PTYPE * npad + j] = (float)t;
        S[S_KAX * npad + j] = (float)K_AX[t];
        S[S_AAX * npad + j] = (float)A_AX[t];
        S[S_BAX * npad + j] = (float)B_AX[t];
        S[S_CK * npad + j] = c[K_AX[t]];
        S[S_CA * npad + j] = c[A_AX[t]];
        S[S_CB * npad + j] = c[B_AX[t]];
        S[S_HA * npad + j] = ha;
        S[S_HB * npad + j] = hb;

        P[P_CX * npad + j] = c[0];
        P[P_CY * npad + j] = c[1];
        P[P_CZ * npad + j] = c[2];
        P[P_MPARAM * npad + j] = mparam[i];
        P[P_PACKA * npad + j] = pack_rgb(&albedo[i * 3]);
        P[P_PACKB * npad + j] = pack_rgb(&albedo2[i * 3]);
        int tid = texid[i] < -1 ? -1 : texid[i];
        int neg = r < 0.0f ? 1 : 0;
        P[P_PACKC * npad + j] =
            (float)(mtype[i] + 4 * textype[i] + 16 * t + 128 * neg +
                    256 * (tid + 1));
        if (with_uv) {  // NOT p_rows>P_HA: vattr layouts reuse rows 7-8
            P[P_HA * npad + j] = ha;
            P[P_HB * npad + j] = hb;
        }
        prim_map[j] = slot_ids[i];

        if (t == 4) {  // triangle overlay (render_kernel.py layout)
            const float* e1 = &edge1[i * 3];
            const float* e2 = &edge2[i * 3];
            float n2x = e1[1] * e2[2] - e1[2] * e2[1];
            float n2y = e1[2] * e2[0] - e1[0] * e2[2];
            float n2z = e1[0] * e2[1] - e1[1] * e2[0];
            S[S_R2 * npad + j] = -1.0f;
            S[S_HA * npad + j] = -1.0f;
            S[S_HB * npad + j] = -1.0f;
            // Havel-Herout plane precompute in f64, rounded once to f32 —
            // op ordering mirrors the numpy packer EXACTLY (bit-identity
            // enforced by tests/test_mesh.py).
            double nx = n2x, ny = n2y, nz = n2z;
            double e1x = e1[0], e1y = e1[1], e1z = e1[2];
            double e2x = e2[0], e2y = e2[1], e2z = e2[2];
            double v0x = c[0], v0y = c[1], v0z = c[2];
            double den = nx * nx + ny * ny + nz * nz;
            if (den < 1e-300) den = 1e-300;  // degenerate: |N.d|<=eps rejects
            double n1x = (e2y * nz - e2z * ny) / den;
            double n1y = (e2z * nx - e2x * nz) / den;
            double n1z = (e2x * ny - e2y * nx) / den;
            double m2x = (ny * e1z - nz * e1y) / den;
            double m2y = (nz * e1x - nx * e1z) / den;
            double m2z = (nx * e1y - ny * e1x) / den;
            double d_n = nx * v0x + ny * v0y + nz * v0z;
            double d1 = -(v0x * n1x + v0y * n1y + v0z * n1z);
            double d2 = -(v0x * m2x + v0y * m2y + v0z * m2z);
            S[S_NX * npad + j] = (float)nx;
            S[S_NY * npad + j] = (float)ny;
            S[S_NZ * npad + j] = (float)nz;
            S[S_N1X * npad + j] = (float)n1x;
            S[S_N1Y * npad + j] = (float)n1y;
            S[S_N1Z * npad + j] = (float)n1z;
            S[S_M2X * npad + j] = (float)m2x;
            S[S_M2Y * npad + j] = (float)m2y;
            S[S_M2Z * npad + j] = (float)m2z;
            S[S_DN * npad + j] = (float)d_n;
            S[S_D1 * npad + j] = (float)d1;
            S[S_D2 * npad + j] = (float)d2;
            // payload CX/CY/CZ = unit outward normal (f32 ops ordered to
            // match numpy: sqrt(x*x + y*y + z*z), then one divide each)
            float nn = std::sqrt(n2x * n2x + n2y * n2y + n2z * n2z);
            if (nn < 1e-20f) nn = 1e-20f;
            P[P_CX * npad + j] = n2x / nn;
            P[P_CY * npad + j] = n2y / nn;
            P[P_CZ * npad + j] = n2z / nn;

            if (with_vattrs) {
                // per-vertex attr rows (render_kernel.py p_rows_for):
                // quantized normals at vn_base, uv0+deltas after (with_uv)
                int vb = (with_uv ? 9 : 7);
                P[(vb + 0) * npad + j] = pack_vn(&vn0[i * 3]);
                P[(vb + 1) * npad + j] = pack_vn(&vn1[i * 3]);
                P[(vb + 2) * npad + j] = pack_vn(&vn2[i * 3]);
                if (with_uv) {
                    const float* a0 = &uv0[i * 2];
                    const float* a1 = &uv1[i * 2];
                    const float* a2 = &uv2[i * 2];
                    P[(vb + 3) * npad + j] = a0[0];
                    P[(vb + 4) * npad + j] = a0[1];
                    P[(vb + 5) * npad + j] = a1[0] - a0[0];
                    P[(vb + 6) * npad + j] = a1[1] - a0[1];
                    P[(vb + 7) * npad + j] = a2[0] - a0[0];
                    P[(vb + 8) * npad + j] = a2[1] - a0[1];
                }
            }
        }
    }

    // ---- cluster AABBs + kind, supercluster AABBs ----
    int n_super = std::max(1, (ncols + span - 1) / span);
    for (int ci = 0; ci * cluster < ncols; ++ci) {
        // kind row: 0 all spheres, 1 all rects, 3 all triangles, 2 mixed
        bool any = false;
        int kind = -1;
        bool mixed = false;
        float lo[3] = {BIG, BIG, BIG}, hi[3] = {-BIG, -BIG, -BIG};
        for (int j = ci * cluster; j < (ci + 1) * cluster && j < ncols; ++j) {
            int i = cols[j];
            if (i < 0) continue;
            any = true;
            int k2 = ptype[i] == 0 ? 0 : (ptype[i] == 4 ? 3 : 1);
            if (kind < 0) kind = k2;
            else if (kind != k2) mixed = true;
            for (int k = 0; k < 3; ++k) {
                lo[k] = std::min(lo[k], bmin[i * 3 + k]);
                hi[k] = std::max(hi[k], bmax[i * 3 + k]);
            }
        }
        if (!any) continue;
        for (int k = 0; k < 3; ++k) {
            clus[k * nc + ci] = lo[k];
            clus[(k + 3) * nc + ci] = hi[k];
        }
        clus[6 * nc + ci] = mixed ? 2.0f : (float)kind;
    }
    for (int si = 0; si < n_super; ++si) {
        bool any = false;
        float lo[3] = {BIG, BIG, BIG}, hi[3] = {-BIG, -BIG, -BIG};
        for (int j = si * span; j < (si + 1) * span && j < ncols; ++j) {
            int i = cols[j];
            if (i < 0) continue;
            any = true;
            for (int k = 0; k < 3; ++k) {
                lo[k] = std::min(lo[k], bmin[i * 3 + k]);
                hi[k] = std::max(hi[k], bmax[i * 3 + k]);
            }
        }
        if (!any) continue;
        for (int k = 0; k < 3; ++k) {
            supers[k * nsc + si] = lo[k];
            supers[(k + 3) * nsc + si] = hi[k];
        }
    }
    *out_n_super = n_super;
    return 0;
}
