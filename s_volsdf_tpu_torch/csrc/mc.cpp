// Isosurface extraction by marching tetrahedra, the host core of the
// port's mesh export (engine/mesh.py): a copy of
// s_volsdf_tpu/native/mc.cpp, built by ops/build.py with the same g++
// flags as the JAX package's build (-O3 -shared -fPIC), so both
// produce the same mesh from the same volume.
//
// Each grid cell splits into 6 tetrahedra; each tetrahedron contributes
// 0-2 triangles with vertices linearly interpolated on its edges.
// Vertices are deduplicated on (grid-edge endpoints) keys so the output
// is a proper shared-vertex mesh. Output vertex coordinates are in
// voxel-index space (caller applies spacing + origin), matching the
// skimage convention.

#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// 6-tetrahedra decomposition of the unit cube. Corner numbering:
// bit 0 -> +x, bit 1 -> +y, bit 2 -> +z  (corner = x | y<<1 | z<<2).
static const int TETS[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
    {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 4, 7, 6},
};

struct Builder {
    std::vector<float> verts;
    std::vector<int64_t> tris;
    std::unordered_map<uint64_t, int64_t> edge_cache;
    const float* vol;
    int64_t nx, ny, nz;
    float level;

    inline float val(int64_t x, int64_t y, int64_t z) const {
        return vol[(x * ny + y) * nz + z];
    }

    // Vertex on the edge between grid points a and b (linear interp).
    int64_t edge_vertex(int64_t ax, int64_t ay, int64_t az,
                        int64_t bx, int64_t by, int64_t bz) {
        uint64_t ia = (uint64_t)((ax * ny + ay) * nz + az);
        uint64_t ib = (uint64_t)((bx * ny + by) * nz + bz);
        uint64_t key = ia < ib ? (ia << 32) | ib : (ib << 32) | ia;
        auto it = edge_cache.find(key);
        if (it != edge_cache.end()) return it->second;

        float va = val(ax, ay, az);
        float vb = val(bx, by, bz);
        float denom = vb - va;
        float t = denom != 0.0f ? (level - va) / denom : 0.5f;
        if (t < 0.0f) t = 0.0f;
        if (t > 1.0f) t = 1.0f;
        float px = (float)ax + t * (float)(bx - ax);
        float py = (float)ay + t * (float)(by - ay);
        float pz = (float)az + t * (float)(bz - az);
        int64_t idx = (int64_t)(verts.size() / 3);
        verts.push_back(px);
        verts.push_back(py);
        verts.push_back(pz);
        edge_cache.emplace(key, idx);
        return idx;
    }

    void run() {
        // Corner offsets by bit pattern.
        int64_t cx[8], cy[8], cz[8];
        for (int c = 0; c < 8; ++c) {
            cx[c] = (c >> 0) & 1;
            cy[c] = (c >> 1) & 1;
            cz[c] = (c >> 2) & 1;
        }
        for (int64_t x = 0; x + 1 < nx; ++x) {
            for (int64_t y = 0; y + 1 < ny; ++y) {
                for (int64_t z = 0; z + 1 < nz; ++z) {
                    float cv[8];
                    bool any_lo = false, any_hi = false;
                    for (int c = 0; c < 8; ++c) {
                        cv[c] = val(x + cx[c], y + cy[c], z + cz[c]);
                        (cv[c] < level ? any_lo : any_hi) = true;
                    }
                    if (!any_lo || !any_hi) continue;  // uniform cell

                    for (int t = 0; t < 6; ++t) {
                        const int* tet = TETS[t];
                        int inside = 0;
                        for (int k = 0; k < 4; ++k)
                            if (cv[tet[k]] < level) inside |= 1 << k;
                        if (inside == 0 || inside == 15) continue;
                        emit_tet(x, y, z, cx, cy, cz, tet, inside);
                    }
                }
            }
        }
    }

    inline int64_t ev(int64_t x, int64_t y, int64_t z,
                      const int64_t* cx, const int64_t* cy,
                      const int64_t* cz, int a, int b) {
        return edge_vertex(x + cx[a], y + cy[a], z + cz[a],
                           x + cx[b], y + cy[b], z + cz[b]);
    }

    void tri(int64_t a, int64_t b, int64_t c) {
        tris.push_back(a);
        tris.push_back(b);
        tris.push_back(c);
    }

    // Standard 14 non-trivial marching-tetrahedra cases. `inside`
    // bit k set => tet vertex k is below the level.
    void emit_tet(int64_t x, int64_t y, int64_t z, const int64_t* cx,
                  const int64_t* cy, const int64_t* cz, const int* tet,
                  int inside) {
        const int A = tet[0], B = tet[1], C = tet[2], D = tet[3];
        auto E = [&](int p, int q) { return ev(x, y, z, cx, cy, cz, p, q); };
        switch (inside) {
            // single vertex inside: one triangle, oriented so the
            // surface normal points toward higher values.
            case 1:  tri(E(A,B), E(A,C), E(A,D)); break;
            case 2:  tri(E(B,A), E(B,D), E(B,C)); break;
            case 4:  tri(E(C,A), E(C,B), E(C,D)); break;
            case 8:  tri(E(D,A), E(D,C), E(D,B)); break;
            // single vertex outside: same triangle, flipped.
            case 14: tri(E(A,B), E(A,D), E(A,C)); break;
            case 13: tri(E(B,A), E(B,C), E(B,D)); break;
            case 11: tri(E(C,A), E(C,D), E(C,B)); break;
            case 7:  tri(E(D,A), E(D,B), E(D,C)); break;
            // two inside / two outside: a quad = two triangles.
            case 3:  // A,B inside
                tri(E(A,C), E(A,D), E(B,C));
                tri(E(B,C), E(A,D), E(B,D));
                break;
            case 12: // C,D inside (complement of 3)
                tri(E(A,C), E(B,C), E(A,D));
                tri(E(B,C), E(B,D), E(A,D));
                break;
            case 5:  // A,C inside
                tri(E(A,B), E(C,B), E(A,D));
                tri(E(C,B), E(C,D), E(A,D));
                break;
            case 10: // B,D inside (complement of 5)
                tri(E(A,B), E(A,D), E(C,B));
                tri(E(C,B), E(A,D), E(C,D));
                break;
            case 6:  // B,C inside
                tri(E(B,A), E(C,A), E(B,D));
                tri(E(C,A), E(C,D), E(B,D));
                break;
            case 9:  // A,D inside (complement of 6)
                tri(E(B,A), E(B,D), E(C,A));
                tri(E(C,A), E(B,D), E(C,D));
                break;
            default: break;
        }
    }
};

}  // namespace

extern "C" {

struct MCResult {
    float* verts;
    int64_t n_verts;
    int64_t* tris;
    int64_t n_tris;
};

MCResult* mc_run(const float* vol, int64_t nx, int64_t ny, int64_t nz,
                 float level) {
    Builder b;
    b.vol = vol;
    b.nx = nx;
    b.ny = ny;
    b.nz = nz;
    b.level = level;
    b.run();

    MCResult* r = (MCResult*)std::malloc(sizeof(MCResult));
    r->n_verts = (int64_t)(b.verts.size() / 3);
    r->n_tris = (int64_t)(b.tris.size() / 3);
    r->verts = (float*)std::malloc(b.verts.size() * sizeof(float));
    r->tris = (int64_t*)std::malloc(b.tris.size() * sizeof(int64_t));
    std::copy(b.verts.begin(), b.verts.end(), r->verts);
    std::copy(b.tris.begin(), b.tris.end(), r->tris);
    return r;
}

void mc_free(MCResult* r) {
    if (!r) return;
    std::free(r->verts);
    std::free(r->tris);
    std::free(r);
}

}  // extern "C"
