// Native batch loader for .npy feature caches.
//
// The training host path stacks dozens of per-video .npy files into one
// contiguous batch buffer per step (the reference does this through python
// np.load + default_collate, src/dataset.py:107-180). This library does the
// same work in C++: it parses the .npy v1/v2 header, validates dtype/shape,
// and reads each file's payload DIRECTLY into its slot of a caller-owned
// batch buffer: no intermediate arrays, no GIL, one worker thread per file
// chunk. Exposed through a C ABI that
// qa_tiger_tpu_torch/data/native_loader.py loads with ctypes; it builds this
// file with g++ at first use. Only float32 ('<f4') payloads in C order are
// served natively; anything else returns a code telling the caller to fall
// back to numpy.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = 1;
constexpr int kErrHeader = 2;
constexpr int kErrDtype = 3;     // not '<f4' C-order -> numpy fallback
constexpr int kErrSize = 4;      // payload size mismatch with item_bytes
constexpr int kErrRead = 5;

// Parse a .npy header. On success positions *payload_offset at the data and
// returns kOk. Only enough of the dict is parsed to check descr/order.
int parse_header(FILE* f, int64_t* payload_offset, int64_t* payload_bytes) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return kErrHeader;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return kErrHeader;
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return kErrHeader;
    header_len = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return kErrHeader;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  }
  std::string header(header_len, '\0');
  if (fread(header.data(), 1, header_len, f) != header_len) return kErrHeader;
  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return kErrDtype;
  if (header.find("'fortran_order': False") == std::string::npos &&
      header.find("\"fortran_order\": false") == std::string::npos)
    return kErrDtype;
  *payload_offset = 8 + (major == 1 ? 2 : 4) + header_len;
  if (fseek(f, 0, SEEK_END) != 0) return kErrHeader;
  *payload_bytes = ftell(f) - *payload_offset;
  return kOk;
}

int load_one(const char* path, float* dst, int64_t item_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  int64_t offset = 0, bytes = 0;
  int rc = parse_header(f, &offset, &bytes);
  if (rc != kOk) {
    fclose(f);
    return rc;
  }
  if (bytes < item_bytes) {
    fclose(f);
    return kErrSize;
  }
  if (fseek(f, offset, SEEK_SET) != 0) {
    fclose(f);
    return kErrHeader;
  }
  // read exactly item_bytes (callers may slice a longer cache, e.g. the
  // frame_sample_rate==1 fast path reads the full payload)
  const size_t got = fread(dst, 1, static_cast<size_t>(item_bytes), f);
  fclose(f);
  return got == static_cast<size_t>(item_bytes) ? kOk : kErrRead;
}

}  // namespace

extern "C" {

// Load n .npy files into out[i * item_floats .. ]. Returns 0 on success,
// otherwise the first nonzero per-file error code (also recorded per file in
// `codes` when non-null).
int qa_tiger_load_npy_batch(const char** paths, int64_t n,
                            float* out, int64_t item_floats,
                            int32_t* codes, int32_t num_threads) {
  const int64_t item_bytes = item_floats * 4;
  std::vector<int32_t> local_codes(static_cast<size_t>(n), kOk);
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = static_cast<int32_t>(n);

  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      local_codes[static_cast<size_t>(i)] =
          load_one(paths[i], out + i * item_floats, item_bytes);
    }
  };

  if (num_threads == 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> threads;
    const int64_t chunk = (n + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
      const int64_t begin = t * chunk;
      const int64_t end = begin + chunk < n ? begin + chunk : n;
      if (begin >= end) break;
      threads.emplace_back(worker, begin, end);
    }
    for (auto& th : threads) th.join();
  }

  int rc = kOk;
  for (int64_t i = 0; i < n; ++i) {
    if (codes) codes[i] = local_codes[static_cast<size_t>(i)];
    if (rc == kOk && local_codes[static_cast<size_t>(i)] != kOk)
      rc = local_codes[static_cast<size_t>(i)];
  }
  return rc;
}

}  // extern "C"
