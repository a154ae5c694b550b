// Threaded .npy corpus loader for mdvit_tpu_torch (a copy of the JAX
// package's csrc/npy_loader.cpp).
//
// Each split is loaded ONCE into a dense uint8 array that then lives in the
// card's memory (data/loader.py). A thread pool overlaps file I/O waits and
// parses the minimal npy v1/v2 header inline instead of going through
// numpy's Python reader.
//
// Exposed C ABI (ctypes, see data/native_loader.py):
//   int npy_batch_load(const char** paths, int n, unsigned char* out,
//                      long long item_bytes, long long header_skip_probe,
//                      int n_threads)
// Each file's payload must decode to exactly `item_bytes` bytes (uint8
// arrays of identical shape — the corpus contract); returns 0 on success,
// else the 1-based index of the first failing file.
//
// Built at first use by data/native_loader.py:
//   g++ -O2 -shared -fPIC -pthread -o build/native/<hash>/libnpy_loader.so
//       mdvit_tpu_torch/csrc/npy_loader.cpp

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Extract the quoted string value following `'key':` in the npy header dict.
bool dict_str(const std::string& hdr, const char* key, std::string* out) {
  size_t k = hdr.find(key);
  if (k == std::string::npos) return false;
  size_t colon = hdr.find(':', k + strlen(key));
  if (colon == std::string::npos) return false;
  size_t q1 = hdr.find_first_of("'\"", colon);
  if (q1 == std::string::npos) return false;
  size_t q2 = hdr.find(hdr[q1], q1 + 1);
  if (q2 == std::string::npos) return false;
  *out = hdr.substr(q1 + 1, q2 - q1 - 1);
  return true;
}

// Parse the npy header (v1/v2/v3 all carry the same Python-dict text) and
// validate it against the corpus contract: C-order, payload exactly
// item_bytes (= shape product * itemsize), and — when strict_u8 — a
// byte-sized integer/bool dtype. Returns payload offset, or <0 on any
// mismatch so a heterogeneous / float corpus fails loudly instead of being
// read as raw truncated bytes.
long long payload_offset(FILE* f, long long item_bytes, bool strict_u8) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  int major = magic[6];
  unsigned long long header_len = 0;
  long long base = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return -1;
    header_len = b[0] | (b[1] << 8);
    base = 10;
  } else if (major == 2 || major == 3) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return -1;
    header_len = (unsigned long long)b[0] | ((unsigned long long)b[1] << 8) |
                 ((unsigned long long)b[2] << 16) |
                 ((unsigned long long)b[3] << 24);
    base = 12;
  } else {
    return -1;
  }
  if (header_len == 0 || header_len > (1u << 20)) return -1;
  std::string hdr(header_len, '\0');
  if (fread(&hdr[0], 1, header_len, f) != header_len) return -1;

  // dtype: descr like '|u1', '<f4'; kind letter + trailing itemsize digits.
  std::string descr;
  if (!dict_str(hdr, "descr", &descr) || descr.empty()) return -2;
  char kind = 0;
  long long itemsize = 0;
  for (char c : descr) {
    if (!kind && (c == 'u' || c == 'i' || c == 'b' || c == 'f' || c == 'c' ||
                  c == 'S' || c == 'U' || c == 'V'))
      kind = c;
    else if (c >= '0' && c <= '9')
      itemsize = itemsize * 10 + (c - '0');
  }
  if (!kind || itemsize <= 0) return -2;
  if (strict_u8 && (itemsize != 1 || (kind != 'u' && kind != 'i' && kind != 'b')))
    return -2;

  // fortran_order must be False (payload is raw C-order bytes for us).
  size_t fo = hdr.find("fortran_order");
  if (fo == std::string::npos) return -3;
  size_t val = hdr.find_first_not_of(" :'\"", fo + strlen("fortran_order"));
  if (val == std::string::npos || hdr.compare(val, 5, "False") != 0) return -3;

  // shape tuple product * itemsize must equal the caller's item_bytes.
  size_t sp = hdr.find("shape");
  if (sp == std::string::npos) return -4;
  size_t po = hdr.find('(', sp);
  size_t pc = (po == std::string::npos) ? std::string::npos : hdr.find(')', po);
  if (pc == std::string::npos) return -4;
  long long elems = 1, cur = -1;
  for (size_t i = po + 1; i <= pc; ++i) {
    char c = hdr[i];
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (c == ',' || c == ')') {
      if (cur >= 0) elems *= cur;
      cur = -1;
    } else if (c != ' ') {
      return -4;
    }
  }
  if (elems * itemsize != item_bytes) return -5;
  return base + (long long)header_len;
}

bool load_one(const char* path, unsigned char* dst, long long item_bytes,
              bool strict_u8) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  long long off = payload_offset(f, item_bytes, strict_u8);
  if (off < 0) {
    fclose(f);
    return false;
  }
  if (fseek(f, (long)off, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  size_t got = fread(dst, 1, (size_t)item_bytes, f);
  fclose(f);
  return got == (size_t)item_bytes;
}

}  // namespace

extern "C" {

int npy_batch_load(const char** paths, int n, unsigned char* out,
                   long long item_bytes, int strict_u8, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> first_fail(0);  // 0 = ok, else 1-based index
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || first_fail.load() != 0) return;
      if (!load_one(paths[i], out + (long long)i * item_bytes, item_bytes,
                    strict_u8 != 0)) {
        int expected = 0;
        first_fail.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return first_fail.load();
}

}  // extern "C"
