// Native host data-loader core of heal_tpu_torch.
//
// The port's copy of heal_tpu/native/loader.cpp, function for function:
// the Pascal-VOC "+1" axis-aligned IoU matrix of anchor target
// assignment (bbox_overlaps, f32), the range filter with padding, a PCD
// reader (ascii or binary, any float or integer field size, intensity
// optional) and the spconv-style host voxelizer. These are the CPU hot
// loops of label generation and disk ingest; a plain C interface, loaded
// with ctypes.
//
// Built with g++ at first use by heal_tpu_torch/native/__init__.py, with
// the JAX package's flags (-O3 -march=native -shared -fPIC -std=c++17),
// so that both libraries compute the same bits on one host.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Pascal-VOC "+1" axis-aligned IoU matrix (anchor target assignment).
// boxes (N, 4) [x1 y1 x2 y2], query (K, 4) -> out (N, K)
void bbox_overlaps(const float* boxes, int64_t n, const float* query,
                   int64_t k, float* out, int plus_one) {
  const float off = plus_one ? 1.0f : 0.0f;
  for (int64_t j = 0; j < k; ++j) {
    const float qx1 = query[j * 4 + 0], qy1 = query[j * 4 + 1];
    const float qx2 = query[j * 4 + 2], qy2 = query[j * 4 + 3];
    const float qarea = (qx2 - qx1 + off) * (qy2 - qy1 + off);
    for (int64_t i = 0; i < n; ++i) {
      const float bx1 = boxes[i * 4 + 0], by1 = boxes[i * 4 + 1];
      const float bx2 = boxes[i * 4 + 2], by2 = boxes[i * 4 + 3];
      const float iw = std::min(bx2, qx2) - std::max(bx1, qx1) + off;
      float v = 0.0f;
      if (iw > 0) {
        const float ih = std::min(by2, qy2) - std::max(by1, qy1) + off;
        if (ih > 0) {
          const float ua = (bx2 - bx1 + off) * (by2 - by1 + off) + qarea -
                           iw * ih;
          v = iw * ih / ua;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// ---------------------------------------------------------------------
// Range filter + pad: points (N, 4) -> out (max_out, 4), mask (max_out)
// Returns number of kept points (pre-cap).
int64_t range_filter_pad(const float* pts, int64_t n, const float* range6,
                         float* out, uint8_t* mask, int64_t max_out) {
  int64_t kept = 0, written = 0;
  std::memset(out, 0, sizeof(float) * 4 * max_out);
  std::memset(mask, 0, max_out);
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
    if (x < range6[0] || x > range6[3] || y < range6[1] || y > range6[4] ||
        z < range6[2] || z > range6[5])
      continue;
    ++kept;
    if (written < max_out) {
      std::memcpy(out + written * 4, pts + i * 4, sizeof(float) * 4);
      mask[written] = 1;
      ++written;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------
// Minimal PCD reader (ascii or binary; SIZE/TYPE-aware, so non-float32
// layouts — common in DAIR-V2X exports — decode correctly instead of
// parsing as garbage). Requires x/y/z in FIELDS; returns -1 otherwise.
// Returns the file's total point count (may exceed cap; the caller can
// grow the buffer and retry) and fills out with min(count, cap) points.
static double decode_field(const unsigned char* p, char type, int size) {
  if (type == 'F') {
    if (size == 4) { float v; std::memcpy(&v, p, 4); return v; }
    if (size == 8) { double v; std::memcpy(&v, p, 8); return v; }
  } else if (type == 'I') {
    if (size == 1) { int8_t v; std::memcpy(&v, p, 1); return v; }
    if (size == 2) { int16_t v; std::memcpy(&v, p, 2); return v; }
    if (size == 4) { int32_t v; std::memcpy(&v, p, 4); return v; }
  } else if (type == 'U') {
    if (size == 1) { uint8_t v; std::memcpy(&v, p, 1); return v; }
    if (size == 2) { uint16_t v; std::memcpy(&v, p, 2); return v; }
    if (size == 4) { uint32_t v; std::memcpy(&v, p, 4); return v; }
  }
  return 0.0;
}

int64_t read_pcd(const char* path, float* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int64_t count = 0;
  int n_fields = 4;
  int ascii = 1;
  int xi = -1, yi = -1, zi = -1, ii = -1;
  std::vector<int> sizes;
  std::vector<char> types;
  while (std::fgets(line, sizeof(line), f)) {
    if (std::strncmp(line, "FIELDS", 6) == 0) {
      char* tok = std::strtok(line + 6, " \r\n");
      int idx = 0;
      while (tok) {
        if (!std::strcmp(tok, "x")) xi = idx;
        else if (!std::strcmp(tok, "y")) yi = idx;
        else if (!std::strcmp(tok, "z")) zi = idx;
        else if (!std::strcmp(tok, "intensity")) ii = idx;
        ++idx;
        tok = std::strtok(nullptr, " \r\n");
      }
      n_fields = idx;
    } else if (std::strncmp(line, "SIZE", 4) == 0) {
      char* tok = std::strtok(line + 4, " \r\n");
      while (tok) { sizes.push_back(std::atoi(tok));
                    tok = std::strtok(nullptr, " \r\n"); }
    } else if (std::strncmp(line, "TYPE", 4) == 0) {
      char* tok = std::strtok(line + 4, " \r\n");
      while (tok) { types.push_back(tok[0]);
                    tok = std::strtok(nullptr, " \r\n"); }
    } else if (std::strncmp(line, "POINTS", 6) == 0) {
      count = std::atoll(line + 6);
    } else if (std::strncmp(line, "DATA", 4) == 0) {
      if (std::strstr(line, "binary_compressed")) { std::fclose(f); return -1; }
      ascii = std::strstr(line, "ascii") != nullptr;
      break;
    }
  }
  // x/y/z must exist, else field indices are unresolved (ADVICE r1).
  if (count <= 0 || xi < 0 || yi < 0 || zi < 0 || n_fields <= 0) {
    std::fclose(f);
    return -1;
  }
  const int64_t n = std::min(count, cap);
  if (ascii) {
    std::vector<float> row(n_fields);
    for (int64_t i = 0; i < n; ++i) {
      for (int c = 0; c < n_fields; ++c) {
        if (std::fscanf(f, "%f", &row[c]) != 1) { std::fclose(f); return i; }
      }
      out[i * 4 + 0] = row[xi];
      out[i * 4 + 1] = row[yi];
      out[i * 4 + 2] = row[zi];
      out[i * 4 + 3] = ii >= 0 ? row[ii] : 1.0f;
    }
  } else {
    // default to float32 when SIZE/TYPE are absent (pre-0.7 writers)
    while ((int)sizes.size() < n_fields) sizes.push_back(4);
    while ((int)types.size() < n_fields) types.push_back('F');
    std::vector<int> offs(n_fields, 0);
    int record = 0;
    for (int c = 0; c < n_fields; ++c) { offs[c] = record; record += sizes[c]; }
    if (record <= 0) { std::fclose(f); return -1; }
    std::vector<unsigned char> buf((size_t)n * record);
    size_t got = std::fread(buf.data(), record, n, f);
    for (int64_t i = 0; i < (int64_t)got; ++i) {
      const unsigned char* rec = buf.data() + (size_t)i * record;
      out[i * 4 + 0] = (float)decode_field(rec + offs[xi], types[xi], sizes[xi]);
      out[i * 4 + 1] = (float)decode_field(rec + offs[yi], types[yi], sizes[yi]);
      out[i * 4 + 2] = (float)decode_field(rec + offs[zi], types[zi], sizes[zi]);
      out[i * 4 + 3] = ii >= 0
          ? (float)decode_field(rec + offs[ii], types[ii], sizes[ii]) : 1.0f;
    }
    if ((int64_t)got < n) { std::fclose(f); return (int64_t)got; }
  }
  std::fclose(f);
  return count;
}

// ---------------------------------------------------------------------
// Host voxelizer (spconv VoxelGeneratorV2 parity): points -> up to
// max_voxels voxels with up to max_points points each, plus coords
// (z, y, x) and per-voxel counts. Open-addressing hash on the cell key
// sized by the point count (a dense grid table costs ~90 MB per call at
// a 0.1 m grid and dominates runtime for sparse clouds — ADVICE r1).
int64_t voxelize(const float* pts, int64_t n, const float* range6,
                 const float* voxel_size, int64_t max_voxels,
                 int64_t max_points, float* voxels /* (V, P, 4) */,
                 int32_t* coords /* (V, 3) */,
                 int32_t* counts /* (V,) */) {
  const float vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
  const int nx = (int)std::round((range6[3] - range6[0]) / vx);
  const int ny = (int)std::round((range6[4] - range6[1]) / vy);
  const int nz = (int)std::round((range6[5] - range6[2]) / vz);
  // capacity: next pow2 >= 2 * n distinct-cell upper bound, min 1024
  uint64_t cap = 1024;
  while (cap < (uint64_t)(n > 0 ? 2 * n : 2)) cap <<= 1;
  std::vector<int64_t> keys;
  std::vector<int32_t> vids;
  keys.assign(cap, -1);
  vids.assign(cap, -1);
  const uint64_t mask = cap - 1;
  std::memset(counts, 0, sizeof(int32_t) * max_voxels);
  int64_t v_used = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
    const int xi = (int)std::floor((x - range6[0]) / vx);
    const int yi = (int)std::floor((y - range6[1]) / vy);
    const int zi = (int)std::floor((z - range6[2]) / vz);
    if (xi < 0 || xi >= nx || yi < 0 || yi >= ny || zi < 0 || zi >= nz)
      continue;
    const int64_t key = ((int64_t)zi * ny + yi) * nx + xi;
    uint64_t slot = ((uint64_t)key * 0x9E3779B97F4A7C15ull) & mask;
    while (keys[slot] >= 0 && keys[slot] != key) slot = (slot + 1) & mask;
    int32_t vid = vids[slot];
    if (keys[slot] < 0) {
      if (v_used >= max_voxels) continue;
      vid = (int32_t)v_used++;
      keys[slot] = key;
      vids[slot] = vid;
      coords[vid * 3 + 0] = zi;
      coords[vid * 3 + 1] = yi;
      coords[vid * 3 + 2] = xi;
    }
    int32_t& c = counts[vid];
    if (c < max_points) {
      std::memcpy(voxels + ((int64_t)vid * max_points + c) * 4,
                  pts + i * 4, sizeof(float) * 4);
      ++c;
    }
  }
  return v_used;
}

}  // extern "C"
