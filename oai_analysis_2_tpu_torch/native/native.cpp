// Native host-side geometry kernels.
//
// A copy of oai_analysis_2_tpu/native/native.cpp (the JAX package's host
// helper), kept here so that the port builds from its own source; the
// functions below are that file's, unchanged.
//
// The reference delegates these to VTK's C++ filters
// (vtkPolyDataConnectivityFilter at mesh_processing.py:119-144); here they
// are small, dependency-free C++ routines exposed via a C ABI for ctypes:
// the irreducibly sequential host bookkeeping of the thickness stage
// (components, the smoothing adjacency and its neighbour table).
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17, into
// build/native/ at the root of the checkout at first use
// (oai_analysis_2_tpu_torch/native/__init__.py).

#include <cstdint>
#include <vector>
#include <algorithm>
#include <unordered_map>

extern "C" {

// -- union-find connected components over triangle faces ---------------------
// faces: 3*n_faces int32 vertex indices. labels_out: n_points int32.
// Returns the number of components.
int32_t uf_connected_components(int64_t n_points, int64_t n_faces,
                                const int32_t* faces, int32_t* labels_out) {
    std::vector<int32_t> parent(n_points);
    for (int64_t i = 0; i < n_points; ++i) parent[i] = (int32_t)i;

    auto find = [&](int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];  // path halving
            x = parent[x];
        }
        return x;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a != b) parent[std::max(a, b)] = std::min(a, b);
    };

    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t* tri = faces + 3 * f;
        unite(tri[0], tri[1]);
        unite(tri[1], tri[2]);
    }

    // compact labels
    std::unordered_map<int32_t, int32_t> remap;
    remap.reserve(64);
    int32_t next = 0;
    for (int64_t i = 0; i < n_points; ++i) {
        int32_t r = find((int32_t)i);
        auto it = remap.find(r);
        if (it == remap.end()) { remap.emplace(r, next); labels_out[i] = next; ++next; }
        else labels_out[i] = it->second;
    }
    return next;
}

// -- unique undirected edges + boundary flags ---------------------------------
// Fills edges_out (2*max_edges int32) with unique undirected edges and
// boundary_out (max_edges uint8, 1 = edge belongs to exactly one face).
// Returns the number of unique edges (call with max_edges = 3*n_faces).
int64_t mesh_edges(int64_t n_faces, const int32_t* faces,
                   int32_t* edges_out, uint8_t* boundary_out) {
    std::vector<uint64_t> keys(3 * n_faces);
    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t* tri = faces + 3 * f;
        for (int e = 0; e < 3; ++e) {
            uint64_t a = (uint64_t)tri[e], b = (uint64_t)tri[(e + 1) % 3];
            if (a > b) std::swap(a, b);
            keys[3 * f + e] = (a << 32) | b;
        }
    }
    std::sort(keys.begin(), keys.end());
    int64_t n_edges = 0;
    for (size_t i = 0; i < keys.size();) {
        size_t j = i;
        while (j < keys.size() && keys[j] == keys[i]) ++j;
        edges_out[2 * n_edges] = (int32_t)(keys[i] >> 32);
        edges_out[2 * n_edges + 1] = (int32_t)(keys[i] & 0xffffffffu);
        boundary_out[n_edges] = (j - i == 1) ? 1 : 0;
        ++n_edges;
        i = j;
    }
    return n_edges;
}

// -- smoothing adjacency CSR (boundary rule applied) --------------------------
// faces -> per-vertex neighbor lists for Laplacian smoothing, in one pass:
// unique undirected edges, boundary detection (edge on exactly one face),
// and vtkSmoothPolyDataFilter's boundary rule (a boundary vertex averages
// only over boundary-edge neighbors; interior vertices over all neighbors).
// deg_out: n_points int32. nbr_out: capacity 6*n_faces int32, filled in
// vertex order (CSR with offsets = cumsum(deg)). Returns total neighbors.
// Replaces a ~7 s numpy argsort/unique path at B=8 cohort-batch scale.
int64_t smooth_adjacency_csr(int64_t n_points, int64_t n_faces,
                             const int32_t* faces, int32_t* deg_out,
                             int32_t* nbr_out) {
    std::vector<uint64_t> keys(3 * n_faces);
    for (int64_t f = 0; f < n_faces; ++f) {
        const int32_t* tri = faces + 3 * f;
        for (int e = 0; e < 3; ++e) {
            uint64_t a = (uint64_t)tri[e], b = (uint64_t)tri[(e + 1) % 3];
            if (a > b) std::swap(a, b);
            keys[3 * f + e] = (a << 32) | b;
        }
    }
    std::sort(keys.begin(), keys.end());

    std::vector<uint64_t> edges;
    edges.reserve(keys.size());
    std::vector<uint8_t> edge_boundary;
    edge_boundary.reserve(keys.size());
    std::vector<uint8_t> is_b(n_points, 0);
    for (size_t i = 0; i < keys.size();) {
        size_t j = i;
        while (j < keys.size() && keys[j] == keys[i]) ++j;
        bool b = (j - i == 1);
        edges.push_back(keys[i]);
        edge_boundary.push_back(b ? 1 : 0);
        if (b) {
            is_b[keys[i] >> 32] = 1;
            is_b[(uint32_t)keys[i]] = 1;
        }
        i = j;
    }

    std::fill(deg_out, deg_out + n_points, 0);
    auto keep = [&](int32_t s, bool b) { return !is_b[s] || b; };
    for (size_t e = 0; e < edges.size(); ++e) {
        int32_t a = (int32_t)(edges[e] >> 32);
        int32_t b = (int32_t)(uint32_t)edges[e];
        bool eb = edge_boundary[e] != 0;
        if (keep(a, eb)) ++deg_out[a];
        if (keep(b, eb)) ++deg_out[b];
    }
    std::vector<int64_t> cur(n_points, 0);
    int64_t off = 0;
    for (int64_t i = 0; i < n_points; ++i) {
        cur[i] = off;
        off += deg_out[i];
    }
    for (size_t e = 0; e < edges.size(); ++e) {
        int32_t a = (int32_t)(edges[e] >> 32);
        int32_t b = (int32_t)(uint32_t)edges[e];
        bool eb = edge_boundary[e] != 0;
        if (keep(a, eb)) nbr_out[cur[a]++] = b;
        if (keep(b, eb)) nbr_out[cur[b]++] = a;
    }
    return off;
}

// -- neighbor-table fill from CSR ---------------------------------------------
// Scatter each vertex's CSR neighbor run into its table row (row = slots[v]
// when has_slots, else v; entries remapped through slots likewise). tbl must
// be pre-filled with the dummy index by the caller. Row-sequential writes —
// the numpy fancy-index equivalent costs seconds at cohort-batch scale.
void smooth_fill_table(int64_t n_points, const int32_t* deg, const int32_t* nbr,
                       const int64_t* slots, int32_t has_slots, int64_t k,
                       int32_t* tbl) {
    int64_t off = 0;
    for (int64_t v = 0; v < n_points; ++v) {
        int64_t row = has_slots ? slots[v] : v;
        int32_t* dst = tbl + row * k;
        int64_t d = deg[v];
        if (has_slots) {
            for (int64_t j = 0; j < d; ++j) dst[j] = (int32_t)slots[nbr[off + j]];
        } else {
            for (int64_t j = 0; j < d; ++j) dst[j] = nbr[off + j];
        }
        off += d;
    }
}

}  // extern "C"
