// RecordIO reader of gslora_tpu_torch: mxnet .rec/.idx pairs read with a
// thread pool over pread(2), for the face datasets' host input path
// (reference image_iter.py:18-86, which needs mxnet's C++ recordio).
// Bound to Python with ctypes by gslora_tpu_torch/native; built with
// g++ -O2 -std=c++17 -fPIC -pthread, needing libc and pthreads only.
//
// Record layout (mxnet recordio.h): u32 magic 0xced7230a | u32 lrecord
// (upper 3 bits continuation flag, lower 29 payload length) | payload |
// pad to 4 bytes. The payload starts with IRHeader {u32 flag; f32 label;
// u64 id; u64 id2}; flag > 0 means `flag` f32 labels follow it.
//
// C ABI:
//   ri_open(rec, idx) -> handle or nullptr (also on a malformed .idx line)
//   ri_close(handle)
//   ri_num_records(handle) -> n;  ri_keys(handle, out, cap) -> copied
//   ri_read(handle, pos, &label, out, cap) -> body length, -1 on error,
//       or the needed length when it exceeds cap (nothing copied)
//   ri_read_batch(handle, pos[n], n, labels, out, cap, starts, lengths,
//       threads) -> 0, -1 on any record error, -2 when cap is too small

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kLenMask = (1u << 29) - 1;

struct Reader {
  int fd = -1;
  std::vector<int64_t> keys;
  std::vector<int64_t> offsets;  // offsets[i] belongs to keys[i]
};

#pragma pack(push, 1)
struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};
#pragma pack(pop)

constexpr int64_t kIR = static_cast<int64_t>(sizeof(IRHeader));

// The payload length of the record at table position i from its framing
// header, or -1 when the position, the magic, the continuation flag or the
// length is bad. A nonzero continuation flag marks a multi-part record:
// serving its first part as the whole record would truncate it.
int64_t payload_len(const Reader* r, int64_t i) {
  if (i < 0 || i >= static_cast<int64_t>(r->offsets.size())) return -1;
  uint32_t hdr[2];
  if (pread(r->fd, hdr, 8, r->offsets[i]) != 8) return -1;
  if (hdr[0] != kMagic || (hdr[1] >> 29) != 0) return -1;
  int64_t len = hdr[1] & kLenMask;
  return len < kIR ? -1 : len;
}

// Parse the IRHeader at the front of a payload of `len` bytes: the first
// label into *label, the body's offset into *body_off. A label count that
// runs past the payload is an error (it would read out of bounds).
bool parse_header(const uint8_t* payload, int64_t len, float* label,
                  int64_t* body_off) {
  IRHeader ir;
  std::memcpy(&ir, payload, sizeof(IRHeader));
  *body_off = kIR;
  if (ir.flag > 0) {
    *body_off += 4 * static_cast<int64_t>(ir.flag);
    if (*body_off > len) return false;
    std::memcpy(label, payload + kIR, sizeof(float));
  } else {
    *label = ir.label;
  }
  return true;
}

// Run fn(lo, hi) over [0, n) split into nt contiguous chunks, one thread
// each.
template <class Fn>
void parallel_chunks(int64_t n, int nt, Fn fn) {
  std::vector<std::thread> pool;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo < hi) pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void* ri_open(const char* rec_path, const char* idx_path) {
  int fd = open(rec_path, O_RDONLY);
  if (fd < 0) return nullptr;
  std::ifstream idx(idx_path);
  if (!idx) {
    close(fd);
    return nullptr;
  }
  auto* r = new Reader();
  r->fd = fd;
  // every non-blank line must be exactly "key offset": a malformed line
  // fails the open, as the Python reader reads the whole file
  std::string line;
  while (std::getline(idx, line)) {
    if (line.find_first_not_of(" \t\r\n") == std::string::npos) continue;
    long long key, off;
    char extra;
    if (std::sscanf(line.c_str(), "%lld %lld %c", &key, &off, &extra) != 2) {
      close(fd);
      delete r;
      return nullptr;
    }
    r->keys.push_back(key);
    r->offsets.push_back(off);
  }
  return r;
}

void ri_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->fd >= 0) close(r->fd);
  delete r;
}

int64_t ri_num_records(void* handle) {
  return static_cast<int64_t>(static_cast<Reader*>(handle)->keys.size());
}

int64_t ri_keys(void* handle, int64_t* out, int64_t cap) {
  auto* r = static_cast<Reader*>(handle);
  int64_t n = std::min<int64_t>(cap, r->keys.size());
  std::memcpy(out, r->keys.data(), n * sizeof(int64_t));
  return n;
}

int64_t ri_read(void* handle, int64_t i, float* label, uint8_t* out,
                int64_t cap) {
  auto* r = static_cast<Reader*>(handle);
  int64_t len = payload_len(r, i);
  if (len < 0) return -1;
  std::vector<uint8_t> payload(len);
  if (pread(r->fd, payload.data(), len, r->offsets[i] + 8) != len) return -1;
  int64_t body_off;
  if (!parse_header(payload.data(), len, label, &body_off)) return -1;
  int64_t body_len = len - body_off;
  if (body_len > cap) return body_len;  // the caller retries, bigger
  std::memcpy(out, payload.data() + body_off, body_len);
  return body_len;
}

// Two passes over n table positions. Pass 1 reads the 8-byte framing
// headers for the payload sizes and lays the slots out back to back in
// `out`; pass 2 preads each payload straight into its slot, parses the
// IRHeader there and slides the body to the slot's start.
int ri_read_batch(void* handle, const int64_t* idxs, int64_t n,
                  float* labels, uint8_t* out, int64_t cap, int64_t* starts,
                  int64_t* lengths, int n_threads) {
  auto* r = static_cast<Reader*>(handle);
  int nt = n_threads > 0 ? n_threads : 4;
  std::vector<int64_t> sizes(n);
  std::atomic<int> err{0};
  parallel_chunks(n, nt, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      sizes[j] = payload_len(r, idxs[j]);
      if (sizes[j] < 0) {
        err = 1;
        return;
      }
    }
  });
  if (err) return -1;
  int64_t total = 0;
  for (int64_t j = 0; j < n; ++j) {
    starts[j] = total;
    total += sizes[j];  // the payload bounds the body
  }
  if (total > cap) return -2;
  parallel_chunks(n, nt, [&](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      int64_t len = sizes[j];
      uint8_t* slot = out + starts[j];
      int64_t body_off;
      if (pread(r->fd, slot, len, r->offsets[idxs[j]] + 8) != len ||
          !parse_header(slot, len, &labels[j], &body_off)) {
        err = 1;
        return;
      }
      std::memmove(slot, slot + body_off, len - body_off);
      lengths[j] = len - body_off;
    }
  });
  return err ? -1 : 0;
}

}  // extern "C"
