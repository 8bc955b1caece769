// Native host runtime for open3d_slam_jax.
//
// The reference's runtime is C++ end to end; in this framework the device owns
// the compute path (JAX/XLA/Pallas) and this library owns the host-side
// data plane, where Python costs real latency at 10 Hz:
//
//  - decode_xyz_strided: sensor-packet deserialization (PointCloud2-style
//    strided records -> packed float32 xyz + finite mask), GIL-free.
//    Counterpart of pointmatcher_ros's RosPointCloud2Deserializer.
//  - voxel_downsample_host: hash-map voxel mean for host-side map assembly
//    and export (counterpart of the CPU VoxelHashMap aggregation paths).
//  - ScanRing: fixed-slot drop-oldest ring buffer for raw scan staging
//    between a sensor/reader thread and the SLAM worker (counterpart of
//    CircularBuffer.hpp), mutex-guarded, blob-agnostic.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this
// toolchain). Build: `make -C native` -> libo3s_host.so.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Strided scan decoding.
// ---------------------------------------------------------------------------

// dtype codes: 7 = float32, 8 = float64 (PointField conventions).
// Returns the number of finite points written; out_xyz is densely packed
// with finite points first (compaction included), out_mask[i] marks whether
// input record i was finite.
int64_t decode_xyz_strided(const uint8_t* data, int64_t n_points,
                           int64_t point_step, int64_t x_off, int64_t y_off,
                           int64_t z_off, int32_t dtype, float* out_xyz,
                           uint8_t* out_mask) {
  int64_t n_out = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    const uint8_t* rec = data + i * point_step;
    float x, y, z;
    if (dtype == 7) {
      std::memcpy(&x, rec + x_off, 4);
      std::memcpy(&y, rec + y_off, 4);
      std::memcpy(&z, rec + z_off, 4);
    } else {
      double xd, yd, zd;
      std::memcpy(&xd, rec + x_off, 8);
      std::memcpy(&yd, rec + y_off, 8);
      std::memcpy(&zd, rec + z_off, 8);
      x = static_cast<float>(xd);
      y = static_cast<float>(yd);
      z = static_cast<float>(zd);
    }
    const bool ok = std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
    out_mask[i] = ok ? 1 : 0;
    if (ok) {
      out_xyz[n_out * 3 + 0] = x;
      out_xyz[n_out * 3 + 1] = y;
      out_xyz[n_out * 3 + 2] = z;
      ++n_out;
    }
  }
  return n_out;
}

// Extract an arbitrary float channel (e.g. intensity, time, ring) using the
// mask produced by decode_xyz_strided so channels stay row-aligned with the
// compacted xyz output.
int64_t decode_channel_strided(const uint8_t* data, int64_t n_points,
                               int64_t point_step, int64_t off, int32_t dtype,
                               const uint8_t* mask, float* out) {
  int64_t n_out = 0;
  for (int64_t i = 0; i < n_points; ++i) {
    if (!mask[i]) continue;
    const uint8_t* rec = data + i * point_step;
    float v;
    if (dtype == 7) {
      std::memcpy(&v, rec + off, 4);
    } else if (dtype == 8) {
      double vd;
      std::memcpy(&vd, rec + off, 8);
      v = static_cast<float>(vd);
    } else if (dtype == 2) {  // uint8
      v = static_cast<float>(rec[off]);
    } else if (dtype == 4) {  // uint16
      uint16_t u;
      std::memcpy(&u, rec + off, 2);
      v = static_cast<float>(u);
    } else {
      v = 0.0f;
    }
    out[n_out++] = v;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Host voxel aggregation.
// ---------------------------------------------------------------------------

namespace {
struct VoxelAcc {
  double sx = 0, sy = 0, sz = 0;
  int64_t n = 0;
};
struct KeyHash {
  size_t operator()(const std::tuple<int32_t, int32_t, int32_t>& k) const {
    const uint64_t x = static_cast<uint32_t>(std::get<0>(k));
    const uint64_t y = static_cast<uint32_t>(std::get<1>(k));
    const uint64_t z = static_cast<uint32_t>(std::get<2>(k));
    uint64_t h = x * 2654435761ull ^ (y * 805459861ull << 1) ^ (z * 3674653429ull << 2);
    h ^= h >> 31;
    return static_cast<size_t>(h);
  }
};
}  // namespace

// Voxel-mean downsample of [n, 3] float32 points; writes at most capacity
// voxel centroids into out ([capacity, 3]); returns the number written.
int64_t voxel_downsample_host(const float* xyz, int64_t n, float voxel,
                              float* out, int64_t capacity) {
  std::unordered_map<std::tuple<int32_t, int32_t, int32_t>, VoxelAcc, KeyHash> map;
  map.reserve(static_cast<size_t>(n / 4 + 16));
  const float inv = 1.0f / voxel;
  for (int64_t i = 0; i < n; ++i) {
    const float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    auto key = std::make_tuple(static_cast<int32_t>(std::floor(x * inv)),
                               static_cast<int32_t>(std::floor(y * inv)),
                               static_cast<int32_t>(std::floor(z * inv)));
    auto& acc = map[key];
    acc.sx += x;
    acc.sy += y;
    acc.sz += z;
    acc.n += 1;
  }
  int64_t written = 0;
  for (const auto& kv : map) {
    if (written >= capacity) break;
    const auto& a = kv.second;
    out[written * 3 + 0] = static_cast<float>(a.sx / a.n);
    out[written * 3 + 1] = static_cast<float>(a.sy / a.n);
    out[written * 3 + 2] = static_cast<float>(a.sz / a.n);
    ++written;
  }
  return written;
}

// ---------------------------------------------------------------------------
// Drop-oldest scan ring buffer (opaque blobs).
// ---------------------------------------------------------------------------

namespace {
struct Ring {
  std::mutex mu;
  std::vector<std::vector<uint8_t>> slots;
  std::vector<double> stamps;
  size_t head = 0;  // next pop
  size_t count = 0;
  int64_t dropped = 0;
};
}  // namespace

void* ring_create(int64_t capacity) {
  Ring* r = new Ring();
  r->slots.resize(static_cast<size_t>(capacity));
  r->stamps.resize(static_cast<size_t>(capacity));
  return r;
}

void ring_destroy(void* handle) { delete static_cast<Ring*>(handle); }

// Push a blob; overwrites the oldest entry when full (returns 1 if a drop
// happened, else 0).
int32_t ring_push(void* handle, const uint8_t* data, int64_t size, double stamp) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  const size_t cap = r->slots.size();
  int32_t dropped = 0;
  size_t idx;
  if (r->count == cap) {
    idx = r->head;
    r->head = (r->head + 1) % cap;
    r->dropped += 1;
    dropped = 1;
  } else {
    idx = (r->head + r->count) % cap;
    r->count += 1;
  }
  r->slots[idx].assign(data, data + size);
  r->stamps[idx] = stamp;
  return dropped;
}

// Peek size of the oldest blob (-1 when empty).
int64_t ring_peek_size(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  if (r->count == 0) return -1;
  return static_cast<int64_t>(r->slots[r->head].size());
}

// Pop the oldest blob into out (must be at least peek_size bytes). Returns
// its size, or -1 when empty. stamp_out receives the timestamp.
int64_t ring_pop(void* handle, uint8_t* out, int64_t out_capacity, double* stamp_out) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  if (r->count == 0) return -1;
  auto& blob = r->slots[r->head];
  const int64_t size = static_cast<int64_t>(blob.size());
  if (size > out_capacity) return -2;
  std::memcpy(out, blob.data(), blob.size());
  *stamp_out = r->stamps[r->head];
  blob.clear();
  r->head = (r->head + 1) % r->slots.size();
  r->count -= 1;
  return size;
}

int64_t ring_count(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  return static_cast<int64_t>(r->count);
}

int64_t ring_dropped(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  std::lock_guard<std::mutex> lock(r->mu);
  return r->dropped;
}

// ---------------------------------------------------------------------------
// LZ4 decompression (rosbag 'lz4' chunk compression; roslz4 writes the
// standard LZ4 Frame format, magic 0x184D2204). Only decompression is
// needed (bag READING); checksums are skipped, sizes are validated.
// ---------------------------------------------------------------------------

// Raw LZ4 block decode. Returns bytes written, or -1 on malformed input /
// overflow. Reference: the LZ4 block format spec (token = literal|match
// nibbles, 15 -> extension bytes, little-endian u16 match offset,
// match length 4 + nibble).
int64_t lz4_block_decode(const uint8_t* src, int64_t src_len, uint8_t* dst,
                         int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  while (ip < iend) {
    const uint8_t token = *ip++;
    // Literals.
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    // Match.
    if (ip + 2 > iend) return -1;
    const int64_t offset = static_cast<int64_t>(ip[0]) | (static_cast<int64_t>(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 0x0F);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t* match = op - offset;
    // Overlapping copy must run forward byte-wise.
    for (int64_t i = 0; i < mlen; ++i) op[i] = match[i];
    op += mlen;
  }
  return op - dst;
}

// LZ4 Frame decode. Returns bytes written, -1 on malformed input.
int64_t lz4_frame_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  if (n < 7) return -1;
  const uint32_t magic = static_cast<uint32_t>(ip[0]) | (static_cast<uint32_t>(ip[1]) << 8) |
                         (static_cast<uint32_t>(ip[2]) << 16) | (static_cast<uint32_t>(ip[3]) << 24);
  if (magic != 0x184D2204u) return -1;
  ip += 4;
  const uint8_t flg = *ip++;
  ip++;  // BD byte (block max size) — not needed for decode
  if (((flg >> 6) & 0x3) != 1) return -1;  // version must be 01
  const bool b_checksum = (flg >> 4) & 1;
  const bool c_size = (flg >> 3) & 1;
  if (c_size) ip += 8;
  if (flg & 1) ip += 4;  // DictID
  ip += 1;               // header checksum
  uint8_t* op = dst;
  while (ip + 4 <= iend) {
    const uint32_t bsz = static_cast<uint32_t>(ip[0]) | (static_cast<uint32_t>(ip[1]) << 8) |
                         (static_cast<uint32_t>(ip[2]) << 16) | (static_cast<uint32_t>(ip[3]) << 24);
    ip += 4;
    if (bsz == 0) return op - dst;  // EndMark
    const bool raw = bsz & 0x80000000u;
    const int64_t len = bsz & 0x7FFFFFFFu;
    if (ip + len > iend) return -1;
    if (raw) {
      if (op + len > dst + cap) return -1;
      std::memcpy(op, ip, static_cast<size_t>(len));
      op += len;
    } else {
      const int64_t w = lz4_block_decode(ip, len, op, cap - (op - dst));
      if (w < 0) return -1;
      op += w;
    }
    ip += len;
    if (b_checksum) ip += 4;
  }
  return -1;  // missing EndMark
}

}  // extern "C"
