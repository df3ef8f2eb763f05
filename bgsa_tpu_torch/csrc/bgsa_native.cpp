// Native host-side runtime for bgsa_tpu_torch.
//
// The reference implements its whole host runtime in C (file I/O, packing,
// result conversion — e.g. original/BGSA_CPU/convert.c:167-277, global.c:25-70).
// The port's compute path is CUDA; this library provides C++ equivalents
// for the host-side paths that are hot at production scale and slow in
// Python: the database reader's line encode and transport packing,
// blocked-result-to-text conversion and the host packers.
//
// The port's copy of bgsa_tpu's native/bgsa_native.cpp: the same functions,
// plus bgsa_encode_lines, bgsa_encode_transport and bgsa_list_n. Exposed as
// a plain C ABI consumed via ctypes.
// Build: g++ -O3 -march=native -shared -fPIC -o libbgsa_native.so bgsa_native.cpp
// (bgsa_tpu_torch.native builds it on demand and falls back to Python
// otherwise). This file is not a CUDA source: ops/build.py compiles only the
// .cu files it lists.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>
#include <atomic>
#include <thread>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

// The transport packers memcpy code bytes into uint16/uint32 and OR-fold
// shifted copies, which assumes little-endian byte order (as does the raw
// .info/result struct I/O below). A big-endian build would silently produce
// a different packed layout than pack.two_bit_pack and corrupt every upload.
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__)
#error "bgsa_native assumes a little-endian host (word-folded transport packers)"
#endif

namespace {

// Fast signed-int-to-decimal into buf; returns chars written.
inline int itoa_fast(long v, char* buf) {
  char tmp[24];
  int n = 0;
  bool neg = v < 0;
  unsigned long u = neg ? -(unsigned long)v : (unsigned long)v;
  do {
    tmp[n++] = '0' + (u % 10);
    u /= 10;
  } while (u);
  int m = 0;
  if (neg) buf[m++] = '-';
  while (n) buf[m++] = tmp[--n];
  return m;
}

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = st.st_size;
    if (size == 0) { data = nullptr; return true; }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    data = static_cast<const uint8_t*>(p);
    return true;
  }
  ~MappedFile() {
    if (data) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};

inline long load_score(const uint8_t* base, int64_t idx, int itemsize) {
  if (itemsize == 2) return reinterpret_cast<const int16_t*>(base)[idx];
  return reinterpret_cast<const int8_t*>(base)[idx];
}

// Run fn(row_begin, row_end) over [0, S) on up to nthreads std::threads —
// the analogue of the reference's `omp parallel for` over its handle_reads
// row loops (original/BGSA_SSE/global.c:26-69 runs under cal_sse.c:72's
// OpenMP region, thread count = the aligner's -N flag).
template <typename Fn>
void parallel_rows(int64_t S, int nthreads, Fn fn) {
  if (nthreads < 1) nthreads = 1;
  int64_t max_useful = (S + 1023) / 1024;  // >=1k rows per thread or don't bother
  if (nthreads > max_useful) nthreads = (int)max_useful;
  if (nthreads <= 1) {
    fn((int64_t)0, S);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  int64_t per = (S + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t b = t * per, e = b + per < S ? b + per : S;
    if (b >= e) break;
    pool.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : pool) th.join();
}

// The symbol code of one ASCII byte, exactly pack.MAPPING: A, C, G, T, N ->
// 0..4 and every other byte (lowercase and '\r' included) 0. One compare per
// symbol and no table or branch, so random bases cost no misprediction.
inline uint8_t encode_byte(uint8_t b) {
  return (uint8_t)((b == 'C') | ((b == 'G') << 1) | ((b == 'T') * 3) | ((b == 'N') << 2));
}

#ifdef __AVX2__
// encode_byte on 32 bytes at once: each compare's 0xFF lanes masked to the
// symbol's code, the four ORed together.
inline __m256i encode_vector(__m256i v) {
  const __m256i c = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('C')),
                                     _mm256_set1_epi8(1));
  const __m256i g = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('G')),
                                     _mm256_set1_epi8(2));
  const __m256i t = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('T')),
                                     _mm256_set1_epi8(3));
  const __m256i n = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('N')),
                                     _mm256_set1_epi8(4));
  return _mm256_or_si256(_mm256_or_si256(c, g), _mm256_or_si256(t, n));
}
#endif

// One line of `length` bytes to `length` codes. From 32 bytes on, whole
// vectors, the last one overlapping the one before it where `length` is no
// multiple of 32 (it rewrites the same codes); shorter lines, and builds
// without AVX2, take encode_byte a byte at a time.
inline void encode_line(const uint8_t* in, uint8_t* out, int64_t length) {
#ifdef __AVX2__
  if (length >= 32) {
    int64_t i = 0;
    for (; i + 32 <= length; i += 32)
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                          encode_vector(_mm256_loadu_si256(
                              reinterpret_cast<const __m256i*>(in + i))));
    if (i < length) {
      i = length - 32;
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                          encode_vector(_mm256_loadu_si256(
                              reinterpret_cast<const __m256i*>(in + i))));
    }
    return;
  }
#endif
  for (int64_t i = 0; i < length; i++) out[i] = encode_byte(in[i]);
}

// The 2-bit transport code of one ASCII byte: encode_byte with 'N' (and
// every byte outside ACGT) read as 0, as select_transport's "2bitN" payload
// holds it; the sidecar carries the 'N's.
inline uint8_t two_bit_byte(uint8_t b) {
  return (uint8_t)((b == 'C') | ((b == 'G') << 1) | ((b == 'T') * 3));
}

#ifdef __AVX2__
// two_bit_byte on 32 bytes at once, and the mask of the lanes that hold 'N'.
inline __m256i two_bit_vector(__m256i v, uint32_t* n_lanes) {
  const __m256i c = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('C')),
                                     _mm256_set1_epi8(1));
  const __m256i g = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('G')),
                                     _mm256_set1_epi8(2));
  const __m256i t = _mm256_and_si256(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('T')),
                                     _mm256_set1_epi8(3));
  *n_lanes = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, _mm256_set1_epi8('N')));
  return _mm256_or_si256(_mm256_or_si256(c, g), t);
}

// 32 codes 0..3 to 8 bytes, code j of a byte in its bits 2j, 2j + 1 (the
// layout of bgsa_two_bit_pack): c0 + 4 c1 a 16-bit lane, then + 16 (c2 +
// 4 c3) a 32-bit lane, then each 32-bit lane's low byte gathered in order.
inline uint64_t pack_two_bit_vector(__m256i codes) {
  const __m256i pairs = _mm256_maddubs_epi16(codes, _mm256_set1_epi16(0x0401));
  const __m256i quads = _mm256_madd_epi16(pairs, _mm256_set1_epi32(0x00100001));
  const __m256i low = _mm256_shuffle_epi8(
      quads, _mm256_setr_epi8(0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                              0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1));
  const __m256i both =
      _mm256_permutevar8x32_epi32(low, _mm256_setr_epi32(0, 4, 0, 0, 0, 0, 0, 0));
  return (uint64_t)_mm_cvtsi128_si64(_mm256_castsi256_si128(both));
}

// A 32-byte vector's first r lanes (0 < r < 32): load from kKeep + 32 - r.
alignas(64) const uint8_t kKeep[64] = {
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF,
    0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF};
#endif

// One line of `length` bytes to its (length + 3) / 4 two-bit bytes at
// `out`, zero bits past the line's end; returns the line's 'N' count. With
// AVX2, whole vectors, then one more for the last length % 32 bytes: it
// loads 32 bytes from the line's bytes on (its newline and the next line
// after them) where the bucket, which ends at `end`, holds them, or else
// from a copy of the rest of the line; lanes past the line count and pack
// nothing. Without AVX2, two_bit_byte a byte at a time.
inline int64_t two_bit_line(const uint8_t* line, const uint8_t* end, int64_t length,
                            uint8_t* out) {
  int64_t n = 0, i = 0;
#ifdef __AVX2__
  uint32_t lanes;
  for (; i + 32 <= length; i += 32) {
    const uint64_t w = pack_two_bit_vector(two_bit_vector(
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(line + i)), &lanes));
    memcpy(out + i / 4, &w, 8);
    n += __builtin_popcount(lanes);
  }
  const int64_t r = length - i;
  if (r) {
    const uint8_t* src = line + i;
    alignas(32) uint8_t rest[32];
    if (end - src < 32) {
      memcpy(rest, src, (size_t)r);
      memset(rest + r, 0, (size_t)(32 - r));
      src = rest;
    }
    __m256i codes = two_bit_vector(_mm256_loadu_si256(reinterpret_cast<const __m256i*>(src)),
                                   &lanes);
    codes = _mm256_and_si256(codes, _mm256_loadu_si256(
                                        reinterpret_cast<const __m256i*>(kKeep + 32 - r)));
    const uint64_t w = pack_two_bit_vector(codes);
    memcpy(out + i / 4, &w, (size_t)((r + 3) / 4));
    n += __builtin_popcount(lanes & ((1u << r) - 1));
  }
  return n;
#else
  (void)end;
  for (; i < length; i += 4) {
    uint8_t b = 0;
    for (int64_t j = 0; j < 4 && i + j < length; j++) {
      b |= two_bit_byte(line[i + j]) << (2 * j);
      n += line[i + j] == 'N';
    }
    out[i / 4] = b;
  }
  return n;
#endif
}

}  // namespace

extern "C" {

// Blocked binary result -> one decimal score per line (reference convert -r
// semantics). itemsize: 2 (full alignment) or 1 (banded). Returns 0 on
// success, negative errno-style codes otherwise.
int bgsa_convert_result(const char* result_path, const char* info_path,
                        const char* out_path, int itemsize,
                        int ref_bucket_count) {
  FILE* info = fopen(info_path, "rb");
  if (!info) return -1;
  int32_t block_num = 0, device_num = 0;
  int64_t ref_count = 0;
  if (fread(&block_num, 4, 1, info) != 1 || fread(&device_num, 4, 1, info) != 1 ||
      fread(&ref_count, 8, 1, info) != 1) {
    fclose(info);
    return -2;
  }
  // The Python caller (io/result.convert_result) validates the manifest and
  // result size before dispatching here; these guards keep a direct caller
  // with a corrupt header from a bad_alloc/terminate or an mmap overrun.
  if (block_num < 0 || device_num < 1 || ref_count < 0 ||
      (int64_t)block_num * device_num > (int64_t)1 << 32) {
    fclose(info);
    return -2;
  }
  std::vector<int64_t> counts((size_t)block_num * device_num);
  std::vector<int32_t> extras(block_num);
  for (int j = 0; j < block_num; j++) {
    if (fread(&counts[(size_t)j * device_num], 8, device_num, info) != (size_t)device_num ||
        fread(&extras[j], 4, 1, info) != 1) {
      fclose(info);
      return -2;
    }
  }
  fclose(info);

  MappedFile res;
  if (!res.open(result_path)) return -3;

  // Query buckets.
  std::vector<std::pair<int64_t, int64_t>> qbuckets;
  for (int64_t s = 0; s < ref_count; s += ref_bucket_count)
    qbuckets.emplace_back(s, std::min<int64_t>(s + ref_bucket_count, ref_count));
  if (qbuckets.empty()) qbuckets.emplace_back(0, 0);

  // Element offset of each (block, qbucket, device) matrix in file order.
  std::vector<int64_t> offs((size_t)block_num * qbuckets.size() * device_num);
  int64_t pos = 0;
  for (int j = 0; j < block_num; j++)
    for (size_t m = 0; m < qbuckets.size(); m++)
      for (int t = 0; t < device_num; t++) {
        offs[((size_t)j * qbuckets.size() + m) * device_num + t] = pos;
        pos += (qbuckets[m].second - qbuckets[m].first) * counts[(size_t)j * device_num + t];
      }
  if ((uint64_t)pos * itemsize != res.size) return -5;  // truncated/mismatched

  FILE* out = fopen(out_path, "wb");
  if (!out) return -4;
  std::vector<char> buf(1 << 20);
  size_t used = 0;
  bool werr = false;
  for (size_t m = 0; m < qbuckets.size(); m++) {
    for (int64_t i = qbuckets[m].first; i < qbuckets[m].second; i++) {
      for (int j = 0; j < block_num; j++) {
        for (int t = 0; t < device_num; t++) {
          int64_t cnt = counts[(size_t)j * device_num + t];
          int64_t keep = cnt - (t == device_num - 1 ? extras[j] : 0);
          int64_t base = offs[((size_t)j * qbuckets.size() + m) * device_num + t] +
                         (i - qbuckets[m].first) * cnt;
          for (int64_t k = 0; k < keep; k++) {
            if (used + 32 > buf.size()) {
              werr |= fwrite(buf.data(), 1, used, out) != used;
              used = 0;
            }
            used += itoa_fast(load_score(res.data, base + k, itemsize), &buf[used]);
            buf[used++] = '\n';
          }
        }
      }
    }
  }
  if (used) werr |= fwrite(buf.data(), 1, used, out) != used;
  werr |= fclose(out) != 0;
  // A short write (ENOSPC/EIO) must not report success over a truncated
  // output; the Python fallback re-runs and raises a proper OSError.
  return werr ? -6 : 0;
}

// Banded Peq packing (see bgsa_tpu_torch.pack.pack_banded_host): initial 64-bit window
// split into lo/hi uint32 planes + injection stream, 5 character planes.
// codes: S x L symbol codes (0..4). inj layout: [char][word][subject],
// inj_words = ceil(max(qlen - k, 1) / 32).
void bgsa_pack_banded(const uint8_t* codes, int64_t S, int64_t L, int32_t k,
                      int32_t qlen, uint32_t* init_lo, uint32_t* init_hi,
                      uint32_t* inj, int32_t inj_words, int32_t nthreads) {
  const int64_t n_inj = qlen - k > 0 ? qlen - k : 1;
  memset(init_lo, 0, sizeof(uint32_t) * 5 * S);
  memset(init_hi, 0, sizeof(uint32_t) * 5 * S);
  memset(inj, 0, sizeof(uint32_t) * 5 * inj_words * S);
  parallel_rows(S, nthreads, [=](int64_t s0, int64_t s1) {
  for (int64_t s = s0; s < s1; s++) {
    const uint8_t* row = codes + s * L;
    uint64_t init[5] = {0, 0, 0, 0, 0};
    const int64_t kk = k < L ? k : L;
    for (int64_t i = 0; i < kk; i++) init[row[i]] |= 1ULL << (k + 1 + i);
    for (int c = 0; c < 5; c++) {
      init_lo[c * S + s] = (uint32_t)(init[c] & 0xffffffffu);
      init_hi[c * S + s] = (uint32_t)(init[c] >> 32);
    }
    const int64_t lim = n_inj < L - k ? n_inj : (L - k > 0 ? L - k : 0);
    for (int64_t t = 0; t < lim; t++) {
      const int c = row[k + t];
      inj[((int64_t)c * inj_words + (t >> 5)) * S + s] |= 1u << (t & 31);
    }
  }
  });
}

// Full-alignment Eq packing (pack.pack_eq layout: [char][word][subject],
// word_bits usable bits per uint32 word).
void bgsa_pack_eq(const uint8_t* codes, int64_t S, int64_t L, int32_t word_bits,
                  uint32_t* eq, int32_t W) {
  memset(eq, 0, sizeof(uint32_t) * 5 * W * S);
  for (int64_t s = 0; s < S; s++) {
    const uint8_t* row = codes + s * L;
    for (int64_t i = 0; i < L; i++) {
      const int c = row[i];
      eq[((int64_t)c * W + i / word_bits) * S + s] |= 1u << (i % word_bits);
    }
  }
}

// Transport packers (the host side of the upload path; the reference packs
// on host cores too, R6). Bit layout matches pack.two_bit_pack /
// pack.nibble_pack exactly: little-endian within the byte, zero padding.
void bgsa_two_bit_pack(const uint8_t* codes, int64_t S, int64_t L,
                       uint8_t* out, int32_t nthreads) {
  int64_t W = (L + 3) / 4;
  parallel_rows(S, nthreads, [=](int64_t s0, int64_t s1) {
  for (int64_t s = s0; s < s1; s++) {
    const uint8_t* row = codes + s * L;
    uint8_t* o = out + s * W;
    int64_t full = L / 4;
    for (int64_t w = 0; w < full; w++) {
      // codes < 4, so OR-folding the word can't collide bits
      uint32_t v;
      memcpy(&v, row + 4 * w, 4);
      o[w] = (uint8_t)((v | (v >> 6) | (v >> 12) | (v >> 18)) & 0xFF);
    }
    if (full < W) {
      uint8_t b = 0;
      for (int64_t i = full * 4; i < L; i++) b |= row[i] << (2 * (i - full * 4));
      o[full] = b;
    }
  }
  });
}

void bgsa_nibble_pack(const uint8_t* codes, int64_t S, int64_t L,
                      uint8_t* out, int32_t nthreads) {
  int64_t W = (L + 1) / 2;
  parallel_rows(S, nthreads, [=](int64_t s0, int64_t s1) {
  for (int64_t s = s0; s < s1; s++) {
    const uint8_t* row = codes + s * L;
    uint8_t* o = out + s * W;
    int64_t full = L / 2;
    for (int64_t w = 0; w < full; w++) {
      uint16_t v;  // codes < 16: (v | v>>4) & 0xFF == c0 | c1<<4
      memcpy(&v, row + 2 * w, 2);
      o[w] = (uint8_t)((v | (v >> 4)) & 0xFF);
    }
    if (full < W) o[full] = row[L - 1];
  }
  });
}

// Count of codes > 3 (N characters) — select_transport's sidecar decision.
int64_t bgsa_count_n(const uint8_t* codes, int64_t n) {
  int64_t c = 0;
  for (int64_t i = 0; i < n; i++) c += codes[i] > 3;
  return c;
}

// The database reader's bucket encode (io/seqfile.py): `rows` lines of
// `length` bytes, `stride` bytes apart in `raw` (length + 1: the newline),
// to rows x length symbol codes written contiguously to `out`, then
// `pad_rows` lines of code 4 ('N', the tail bucket's lane pads) after them.
// Returns the index of the first line whose byte at column `length` is not
// a newline (a ragged file; `out` is then incomplete), or -1.
int64_t bgsa_encode_lines(const uint8_t* raw, int64_t rows, int64_t length,
                          int64_t stride, uint8_t* out, int64_t pad_rows) {
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* line = raw + r * stride;
    if (line[length] != '\n') return r;
    encode_line(line, out + r * length, length);
  }
  memset(out + rows * length, 4, (size_t)(pad_rows * length));
  return -1;
}

// The database reader's bucket encode straight to the 2-bit transport
// (pack.select_transport's payload for N-free codes, and its "2bitN"
// payload otherwise): the lines of bgsa_encode_lines, each to (length + 3)
// / 4 bytes at `out`, 'N' read as 0, then `pad_rows` all-'N' lines (zero
// bytes). Each line's 'N' count goes to `row_n`, and the bucket's, pads
// included, to `*n_count`, for the sidecar (bgsa_list_n). Fans the lines
// out over up to `nthreads` threads; loads nothing past the line bytes'
// last line's newline. Returns the first line whose byte at column
// `length` is not a newline, as bgsa_encode_lines does (`out` is then
// incomplete), or -1.
int64_t bgsa_encode_transport(const uint8_t* raw, int64_t rows, int64_t length,
                              int64_t stride, uint8_t* out, int32_t* row_n,
                              int64_t* n_count, int64_t pad_rows, int32_t nthreads) {
  const int64_t W = (length + 3) / 4;
  const uint8_t* end = rows ? raw + (rows - 1) * stride + length + 1 : raw;
  std::atomic<int64_t> bad{rows}, total{pad_rows * length};
  parallel_rows(rows, nthreads, [&, W, end](int64_t r0, int64_t r1) {
    int64_t n = 0;
    for (int64_t r = r0; r < r1; r++) {
      const uint8_t* line = raw + r * stride;
      if (line[length] != '\n') {
        for (int64_t seen = bad.load(); r < seen && !bad.compare_exchange_weak(seen, r);) {
        }
        break;
      }
      row_n[r] = (int32_t)two_bit_line(line, end, length, out + r * W);
      n += row_n[r];
    }
    total += n;
  });
  memset(out + rows * W, 0, (size_t)(pad_rows * W));
  *n_count = total.load();
  const int64_t first_bad = bad.load();
  return first_bad < rows ? first_bad : -1;
}

// The sidecar of bgsa_encode_transport's bucket: the (row, column) of each
// of its 'N's, pad lines included, in row-major order (np.nonzero's), as
// int32 pairs at `pos`. Visits only the lines whose `row_n` is not 0, then writes the pad
// lines' positions without reading them.
void bgsa_list_n(const uint8_t* raw, int64_t rows, int64_t length, int64_t stride,
                 const int32_t* row_n, int64_t pad_rows, int32_t* pos) {
  for (int64_t r = 0; r < rows; r++) {
    if (!row_n[r]) continue;
    const uint8_t* line = raw + r * stride;
    for (const uint8_t* p = line;
         (p = static_cast<const uint8_t*>(memchr(p, 'N', (size_t)(line + length - p))));
         p++) {
      *pos++ = (int32_t)r;
      *pos++ = (int32_t)(p - line);
    }
  }
  for (int64_t r = rows; r < rows + pad_rows; r++)
    for (int64_t c = 0; c < length; c++) {
      *pos++ = (int32_t)r;
      *pos++ = (int32_t)c;
    }
}

}  // extern "C"
