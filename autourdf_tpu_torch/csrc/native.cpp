// Native host-side runtime of the PyTorch port (copy of
// native/src/autourdf_native.cpp).
//
// The card owns the compute path (PyTorch and the CUDA kernels of knn.cu);
// this library owns the host-side hot loops the reference delegated to C++
// third parties (Open3D I/O, PyMCubes): marching-tetrahedra isosurface
// extraction, binary PLY point-cloud I/O, and farthest-point sampling for
// host-side tooling.  Exposed through a C ABI for ctypes (no pybind11 in the
// toolchain).
//
// Built at first use by autourdf_tpu_torch/io/native.py:
//   g++ -O3 -fPIC -shared -std=c++17 -> autourdf_tpu_torch/_build/libnative_<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Marching tetrahedra (Kuhn 6-tet decomposition, binary field, 0.5 crossing)
// Mirrors autourdf_tpu_torch/mesh/marching.py; the zero pad for closedness is the
// caller's responsibility here (the Python wrapper pads).
// ---------------------------------------------------------------------------

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// corner id bit code: x | y<<1 | z<<2
static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};

// Kuhn tets: coordinate-insertion permutations
static const int kPerm[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};

struct TetCase {
  // up to 2 triangles, each 3 edges (pairs of local tet vertex ids)
  int ntri;
  int edges[2][3][2];
};

void tet_cases(TetCase cases[16]) {
  for (int m = 0; m < 16; ++m) {
    std::vector<int> in, out;
    for (int i = 0; i < 4; ++i) (m & (1 << i) ? in : out).push_back(i);
    TetCase& c = cases[m];
    c.ntri = 0;
    if (in.size() == 1) {
      int a = in[0];
      c.ntri = 1;
      int e[3][2] = {{a, out[0]}, {a, out[1]}, {a, out[2]}};
      memcpy(c.edges[0], e, sizeof(e));
    } else if (in.size() == 3) {
      int a = out[0];
      c.ntri = 1;
      int e[3][2] = {{in[0], a}, {in[2], a}, {in[1], a}};
      memcpy(c.edges[0], e, sizeof(e));
    } else if (in.size() == 2) {
      int a = in[0], b = in[1], p = out[0], q = out[1];
      c.ntri = 2;
      int e0[3][2] = {{a, p}, {b, p}, {b, q}};
      int e1[3][2] = {{a, p}, {b, q}, {a, q}};
      memcpy(c.edges[0], e0, sizeof(e0));
      memcpy(c.edges[1], e1, sizeof(e1));
    }
  }
}

struct Weld {
  // half-integer lattice key -> vertex index
  std::unordered_map<uint64_t, int32_t> map;
  std::vector<double> verts;  // xyz triples

  int32_t add(double x, double y, double z) {
    // coordinates are multiples of 0.5 in index space; key on 2x grid
    auto enc = [](double v) -> uint64_t {
      return (uint64_t)(int64_t)llround(v * 2.0) & 0x1FFFFF;  // 21 bits each
    };
    uint64_t key = enc(x) | (enc(y) << 21) | (enc(z) << 42);
    auto it = map.find(key);
    if (it != map.end()) return it->second;
    int32_t id = (int32_t)(verts.size() / 3);
    map.emplace(key, id);
    verts.push_back(x);
    verts.push_back(y);
    verts.push_back(z);
    return id;
  }
};

}  // namespace

// volume: uint8 (nx, ny, nz) C-order.  Returns counts through out params;
// call twice: first with null buffers to get sizes, then with buffers.
// To avoid recomputation, a handle-based API:

struct MTResult {
  std::vector<double> verts;
  std::vector<int32_t> faces;
};

void* mt_run(const uint8_t* vol, int64_t nx, int64_t ny, int64_t nz) {
  TetCase cases[16];
  tet_cases(cases);

  auto at = [&](int64_t x, int64_t y, int64_t z) -> int {
    return vol[(x * ny + y) * nz + z];
  };

  Weld weld;
  std::vector<int32_t> faces;

  // precompute per-(tet, mask) winding from static geometry
  // flip[t][m] == true -> swap vertices 1 and 2
  bool flip[6][16][2];
  int tets[6][4];
  for (int t = 0; t < 6; ++t) {
    tets[t][0] = 0;
    int cbits = 0;
    for (int s = 0; s < 3; ++s) {
      cbits |= 1 << kPerm[t][s];
      tets[t][s + 1] = cbits;
    }
    for (int m = 1; m < 15; ++m) {
      Vec3 cin{0, 0, 0}, cout{0, 0, 0};
      int nin = 0, nout = 0;
      for (int i = 0; i < 4; ++i) {
        int c = tets[t][i];
        Vec3 p{(double)kCorner[c][0], (double)kCorner[c][1], (double)kCorner[c][2]};
        if (m & (1 << i)) { cin.x += p.x; cin.y += p.y; cin.z += p.z; nin++; }
        else { cout.x += p.x; cout.y += p.y; cout.z += p.z; nout++; }
      }
      cin = {cin.x / nin, cin.y / nin, cin.z / nin};
      cout = {cout.x / nout, cout.y / nout, cout.z / nout};
      for (int tri = 0; tri < cases[m].ntri; ++tri) {
        Vec3 mid[3];
        for (int v = 0; v < 3; ++v) {
          int a = cases[m].edges[tri][v][0], b = cases[m].edges[tri][v][1];
          int ca = tets[t][a], cb = tets[t][b];
          mid[v] = {(kCorner[ca][0] + kCorner[cb][0]) * 0.5,
                    (kCorner[ca][1] + kCorner[cb][1]) * 0.5,
                    (kCorner[ca][2] + kCorner[cb][2]) * 0.5};
        }
        Vec3 n = cross(sub(mid[1], mid[0]), sub(mid[2], mid[0]));
        flip[t][m][tri] = dot(n, sub(cout, cin)) < 0;
      }
    }
  }

  for (int64_t x = 0; x + 1 < nx; ++x)
    for (int64_t y = 0; y + 1 < ny; ++y)
      for (int64_t z = 0; z + 1 < nz; ++z) {
        int corner_vals[8];
        int any = 0, all = 1;
        for (int c = 0; c < 8; ++c) {
          corner_vals[c] = at(x + kCorner[c][0], y + kCorner[c][1], z + kCorner[c][2]);
          any |= corner_vals[c];
          all &= corner_vals[c];
        }
        if (!any || all) continue;
        for (int t = 0; t < 6; ++t) {
          int m = 0;
          for (int i = 0; i < 4; ++i)
            if (corner_vals[tets[t][i]]) m |= 1 << i;
          if (m == 0 || m == 15) continue;
          for (int tri = 0; tri < cases[m].ntri; ++tri) {
            int32_t ids[3];
            for (int v = 0; v < 3; ++v) {
              int a = cases[m].edges[tri][v][0], b = cases[m].edges[tri][v][1];
              int ca = tets[t][a], cb = tets[t][b];
              double px = x + (kCorner[ca][0] + kCorner[cb][0]) * 0.5;
              double py = y + (kCorner[ca][1] + kCorner[cb][1]) * 0.5;
              double pz = z + (kCorner[ca][2] + kCorner[cb][2]) * 0.5;
              ids[v] = weld.add(px, py, pz);
            }
            if (flip[t][m][tri]) std::swap(ids[1], ids[2]);
            faces.push_back(ids[0]);
            faces.push_back(ids[1]);
            faces.push_back(ids[2]);
          }
        }
      }

  auto* res = new MTResult();
  res->verts = std::move(weld.verts);
  res->faces = std::move(faces);
  return res;
}

int64_t mt_num_verts(void* h) { return ((MTResult*)h)->verts.size() / 3; }
int64_t mt_num_faces(void* h) { return ((MTResult*)h)->faces.size() / 3; }
void mt_copy(void* h, double* verts_out, int32_t* faces_out) {
  auto* r = (MTResult*)h;
  memcpy(verts_out, r->verts.data(), r->verts.size() * sizeof(double));
  memcpy(faces_out, r->faces.data(), r->faces.size() * sizeof(int32_t));
}
void mt_free(void* h) { delete (MTResult*)h; }

// ---------------------------------------------------------------------------
// Binary PLY xyz I/O (fast data loader for sequence directories)
// ---------------------------------------------------------------------------

int64_t ply_read_xyz(const char* path, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int64_t n_vertex = 0;
  int n_props = 0, xi = -1, yi = -1, zi = -1;
  std::vector<int> prop_sizes;
  bool binary_le = false;
  while (fgets(line, sizeof(line), f)) {
    if (!strncmp(line, "end_header", 10)) break;
    if (!strncmp(line, "format binary_little_endian", 27)) binary_le = true;
    if (!strncmp(line, "element vertex", 14)) sscanf(line + 14, "%ld", &n_vertex);
    else if (!strncmp(line, "element", 7)) n_vertex = n_vertex;  // later elements ignored
    if (!strncmp(line, "property", 8)) {
      char type[32], name[64];
      if (sscanf(line + 8, "%31s %63s", type, name) == 2) {
        int sz = 4;
        if (!strcmp(type, "double") || !strcmp(type, "float64")) sz = 8;
        else if (!strcmp(type, "uchar") || !strcmp(type, "char") ||
                 !strcmp(type, "uint8") || !strcmp(type, "int8")) sz = 1;
        else if (!strcmp(type, "short") || !strcmp(type, "ushort")) sz = 2;
        if (!strcmp(name, "x")) xi = n_props;
        if (!strcmp(name, "y")) yi = n_props;
        if (!strcmp(name, "z")) zi = n_props;
        prop_sizes.push_back(sz);
        n_props++;
      }
    }
  }
  if (!binary_le || xi < 0 || yi < 0 || zi < 0) { fclose(f); return -2; }
  if (out == nullptr || capacity < n_vertex) { fclose(f); return n_vertex; }

  int stride = 0;
  std::vector<int> offsets(n_props);
  for (int i = 0; i < n_props; ++i) { offsets[i] = stride; stride += prop_sizes[i]; }
  std::vector<uint8_t> buf((size_t)n_vertex * stride);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) { fclose(f); return -3; }
  fclose(f);
  for (int64_t i = 0; i < n_vertex; ++i) {
    const uint8_t* rec = buf.data() + i * stride;
    float v[3];
    const int idxs[3] = {xi, yi, zi};
    for (int k = 0; k < 3; ++k) {
      if (prop_sizes[idxs[k]] == 8) {
        double d; memcpy(&d, rec + offsets[idxs[k]], 8); v[k] = (float)d;
      } else {
        memcpy(&v[k], rec + offsets[idxs[k]], 4);
      }
    }
    out[i * 3 + 0] = v[0];
    out[i * 3 + 1] = v[1];
    out[i * 3 + 2] = v[2];
  }
  return n_vertex;
}

int ply_write_xyz(const char* path, const float* pts, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n"
          "property float x\nproperty float y\nproperty float z\nend_header\n",
          (long)n);
  fwrite(pts, sizeof(float), (size_t)n * 3, f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Farthest point sampling (host-side tooling path)
// ---------------------------------------------------------------------------

void fps_sample(const float* pts, int64_t n, int64_t k, int32_t* out_idx) {
  std::vector<float> mind(n, 1e30f);
  int64_t cur = 0;
  out_idx[0] = 0;
  for (int64_t s = 1; s < k; ++s) {
    const float cx = pts[cur * 3], cy = pts[cur * 3 + 1], cz = pts[cur * 3 + 2];
    float best = -1.0f;
    int64_t best_i = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = pts[i * 3] - cx, dy = pts[i * 3 + 1] - cy, dz = pts[i * 3 + 2] - cz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < mind[i]) mind[i] = d;
      if (mind[i] > best) { best = mind[i]; best_i = i; }
    }
    out_idx[s] = (int32_t)best_i;
    cur = best_i;
  }
}

}  // extern "C"
