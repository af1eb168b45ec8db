// Native batch assembler: threaded .npy loading + zero-padded batch packing.
//
// The port's own copy of the JAX package's C++ assembler.  A pool of C++
// threads reads the per-utterance float32 .npy features and packs them
// straight into the caller's [B, T, C] buffer (plain, pinned or shared
// memory) with zero padding, with no allocation on the hot path.  Exposed
// through a plain C ABI that data/native_batcher.py loads with ctypes,
// which releases the interpreter lock for the call.
//
// .npy support: format version 1.0/2.0, little-endian float32 ('<f4'),
// C-contiguous, 2-D arrays: what data/preprocess.py writes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  size_t data_offset;
  size_t rows;
  size_t cols;
};

// Minimal .npy header parser; returns false on any unsupported layout.
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  const int major = magic[6];
  size_t header_len = 0;
  size_t pre = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (fread(hl, 1, 2, f) != 2) return false;
    header_len = hl[0] | (hl[1] << 8);
    pre = 10;
  } else {
    unsigned char hl[4];
    if (fread(hl, 1, 4, f) != 4) return false;
    header_len = (size_t)hl[0] | ((size_t)hl[1] << 8) |
                 ((size_t)hl[2] << 16) | ((size_t)hl[3] << 24);
    pre = 12;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;
  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return false;
  if (header.find("'fortran_order': False") == std::string::npos &&
      header.find("\"fortran_order\": false") == std::string::npos)
    return false;
  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) sp = header.find("\"shape\":");
  if (sp == std::string::npos) return false;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  unsigned long long rows = 0, cols = 0;
  if (sscanf(shape.c_str(), "%llu , %llu", &rows, &cols) != 2 &&
      sscanf(shape.c_str(), "%llu, %llu", &rows, &cols) != 2)
    return false;
  info->data_offset = pre + header_len;
  info->rows = (size_t)rows;
  info->cols = (size_t)cols;
  return true;
}

// Load one [rows, cols] f32 .npy into out[t_cap, cols_expected] (zero-padded,
// truncated to t_cap rows).  Returns rows actually copied, or -1 on error.
int64_t load_padded(const char* path, float* out, int64_t t_cap,
                    int64_t cols_expected) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) ||
      (int64_t)info.cols != cols_expected) {
    fclose(f);
    return -1;
  }
  const size_t copy_rows =
      info.rows < (size_t)t_cap ? info.rows : (size_t)t_cap;
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  const size_t want = copy_rows * info.cols;
  if (fread(out, sizeof(float), want, f) != want) {
    fclose(f);
    return -1;
  }
  fclose(f);
  // zero the padding rows
  if ((size_t)t_cap > copy_rows) {
    memset(out + copy_rows * info.cols, 0,
           ((size_t)t_cap - copy_rows) * info.cols * sizeof(float));
  }
  return (int64_t)copy_rows;
}

}  // namespace

extern "C" {

// Assemble a batch: for each of n paths, load the .npy into
// batch_out[i * t_cap * cols .. ] zero-padded to t_cap rows.
// lengths_out[i] receives the true row count (clamped to t_cap) or -1.
// Returns 0 on success (all files loaded), else the count of failures.
int assemble_batch(const char** paths, int64_t n, float* batch_out,
                   int64_t* lengths_out, int64_t t_cap, int64_t cols,
                   int64_t num_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      const int64_t got =
          load_padded(paths[i], batch_out + i * t_cap * cols, t_cap, cols);
      lengths_out[i] = got;
      if (got < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Single-file probe used by tests: returns rows (>=0) or -1.
int64_t npy_rows(const char* path, int64_t cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  const bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok || (int64_t)info.cols != cols) return -1;
  return (int64_t)info.rows;
}

}  // extern "C"
