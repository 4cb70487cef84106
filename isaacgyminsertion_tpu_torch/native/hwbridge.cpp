// Native hardware-bridge message codec — the wire runtime of the deploy
// transport (deploy/transport.py).
//
// Role parity: the reference's real-robot layer is a 3.6k-LoC ROS stack
// (algo/deploy/env/*) whose transport is roscpp/TCPROS (native) under thin
// Python wrappers. Here the deploy transport is a length-prefixed binary
// protocol over plain TCP, and this codec implements the hot pack/unpack of
// multi-array messages in C++ (ctypes C ABI; deploy/transport.py falls back
// to a pure-Python codec when the .so is unavailable).
//
// Wire format (little endian), one message:
//   [u32 magic 'IHWB'] [u32 n_arrays]
//   per array: [u32 name_len][name][u32 dtype_code][u32 ndim][u64 dims...]
//              [u64 payload_len][payload bytes]
// dtype codes match native/trajlog.cpp: 0=f32 1=f64 2=i32 3=i64 4=u8 5=bool.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x42574849u;  // 'IHWB' little-endian

inline void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out.insert(out.end(), p, p + 4);
}

inline void put_u64(std::vector<uint8_t>& out, uint64_t v) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
  out.insert(out.end(), p, p + 8);
}

size_t dtype_size(uint32_t code) {
  switch (code) {
    case 0: return 4;  // f32
    case 1: return 8;  // f64
    case 2: return 4;  // i32
    case 3: return 8;  // i64
    default: return 1; // u8 / bool
  }
}

}  // namespace

extern "C" {

// Pack n arrays into one message. Inputs are parallel arrays:
//   names[i]        null-terminated
//   dtype_codes[i]
//   ndims[i], dims  flattened dim list (sum(ndims) entries)
//   payloads[i], payload_lens[i]
// Returns a malloc'd buffer in *out (caller frees via hwb_free) and its
// length as the return value; 0 on failure.
uint64_t hwb_pack(uint32_t n_arrays, const char** names,
                  const uint32_t* dtype_codes, const uint32_t* ndims,
                  const uint64_t* dims_flat, const uint8_t** payloads,
                  const uint64_t* payload_lens, uint8_t** out) {
  std::vector<uint8_t> buf;
  buf.reserve(64);
  put_u32(buf, kMagic);
  put_u32(buf, n_arrays);
  size_t dim_off = 0;
  for (uint32_t i = 0; i < n_arrays; ++i) {
    size_t raw_len = strlen(names[i]);
    if (raw_len > 255) return 0;  // keep both codecs' name contract: <256 bytes
    uint32_t name_len = static_cast<uint32_t>(raw_len);
    put_u32(buf, name_len);
    buf.insert(buf.end(), names[i], names[i] + name_len);
    put_u32(buf, dtype_codes[i]);
    put_u32(buf, ndims[i]);
    uint64_t count = 1;
    for (uint32_t d = 0; d < ndims[i]; ++d) {
      put_u64(buf, dims_flat[dim_off + d]);
      count *= dims_flat[dim_off + d];
    }
    dim_off += ndims[i];
    if (payload_lens[i] != count * dtype_size(dtype_codes[i])) return 0;
    put_u64(buf, payload_lens[i]);
    buf.insert(buf.end(), payloads[i], payloads[i] + payload_lens[i]);
  }
  uint8_t* mem = static_cast<uint8_t*>(malloc(buf.size()));
  if (!mem) return 0;
  memcpy(mem, buf.data(), buf.size());
  *out = mem;
  return buf.size();
}

// Parse a message header scan: fills per-array metadata so the caller can
// allocate numpy arrays and then copy payloads out with hwb_payload.
// Returns the number of arrays, or -1 on malformed input.
int32_t hwb_count(const uint8_t* buf, uint64_t len) {
  if (len < 8) return -1;
  uint32_t magic, n;
  memcpy(&magic, buf, 4);
  memcpy(&n, buf + 4, 4);
  if (magic != kMagic) return -1;
  return static_cast<int32_t>(n);
}

// For array index `idx`: writes name (into name_out, cap name_cap incl. nul),
// dtype code, ndim, dims (into dims_out, cap 8), and returns the byte offset
// of the payload within buf (payload length to *payload_len). -1 on error.
int64_t hwb_array_info(const uint8_t* buf, uint64_t len, uint32_t idx,
                       char* name_out, uint32_t name_cap, uint32_t* dtype_code,
                       uint32_t* ndim, uint64_t* dims_out,
                       uint64_t* payload_len) {
  uint64_t off = 8;
  int32_t n = hwb_count(buf, len);
  if (n < 0 || idx >= static_cast<uint32_t>(n)) return -1;
  for (uint32_t i = 0; i <= idx; ++i) {
    if (off + 4 > len) return -1;
    uint32_t name_len;
    memcpy(&name_len, buf + off, 4);
    off += 4;
    if (off + name_len + 8 > len) return -1;
    const char* nm = reinterpret_cast<const char*>(buf + off);
    off += name_len;
    uint32_t dc, nd;
    memcpy(&dc, buf + off, 4);
    memcpy(&nd, buf + off + 4, 4);
    off += 8;
    if (nd > 8 || off + 8ull * nd + 8 > len) return -1;
    uint64_t dims[8];
    memcpy(dims, buf + off, 8ull * nd);
    off += 8ull * nd;
    uint64_t plen;
    memcpy(&plen, buf + off, 8);
    off += 8;
    // subtract-form bounds check: `off + plen > len` wraps for a crafted
    // plen near 2^64 and would pass; off <= len is guaranteed above
    if (plen > len - off) return -1;
    if (i == idx) {
      if (name_cap == 0 || name_len > name_cap - 1) return -1;  // never truncate names
      memcpy(name_out, nm, name_len);
      name_out[name_len] = 0;
      *dtype_code = dc;
      *ndim = nd;
      memcpy(dims_out, dims, 8ull * nd);
      *payload_len = plen;
      return static_cast<int64_t>(off);
    }
    off += plen;
  }
  return -1;
}

void hwb_free(uint8_t* p) { free(p); }

}  // extern "C"
