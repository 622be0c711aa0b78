// Native IO parsers — the data-loader hot path.
//
// Re-design of the reference's parsing stack (common/io/csv/CsvParser.java,
// LibSvmSourceBatchOp's per-line split, common/linalg/VectorUtil.java
// parse): the JVM reference leans on Flink's netty IO + JIT'd string
// splitting; here the hot loops are C++ compiled -O3, exposed through a
// plain C ABI and driven from Python via ctypes (no pybind11 in the
// image). Two-pass protocol per format: a *_count pass sizes the output,
// the caller allocates numpy buffers, a *_fill pass populates them —
// zero-copy into the arrays the encoder consumes.
//
// The PyTorch port's own copy of the JAX package's native/parser.cpp (the
// same functions, the same bits). Build: see alink_tpu_torch/native/
// __init__.py (c++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// vector literals allow ',' between pairs (VectorUtil.parse_sparse)
inline bool is_sep(char c) { return is_space(c) || c == ','; }

// strtod on a bounded token; advances *p past the number.
inline double parse_num(const char*& p, const char* end) {
  char buf[64];
  int n = 0;
  while (p < end && !is_space(*p) && *p != ':' && *p != ',' && *p != '\n' &&
         n < 63) {
    buf[n++] = *p++;
  }
  buf[n] = '\0';
  return std::strtod(buf, nullptr);
}

inline long parse_int(const char*& p, const char* end) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  return neg ? -v : v;
}

const double kPow10[23] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                           1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                           1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Fast exact float parse: when the token is [+-]digits[.digits] with at
// most 15 mantissa digits, the mantissa fits a double exactly and one
// division by an exactly-representable power of ten is correctly rounded
// — bit-identical to strtod (the standard strtod fast path). Everything
// else (exponents, inf/nan, long mantissas) falls back to strtod.
inline double parse_num_fast(const char*& p, const char* end) {
  const char* s = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int idig = 0, fdig = 0;
  while (p < end && *p >= '0' && *p <= '9' && idig < 16) {
    mant = mant * 10 + (uint64_t)(*p++ - '0');
    idig++;
  }
  if (p < end && *p == '.') {
    p++;
    while (p < end && *p >= '0' && *p <= '9' && idig + fdig < 16) {
      mant = mant * 10 + (uint64_t)(*p++ - '0');
      fdig++;
    }
  }
  // fall back to strtod whenever the fast scan did not stop at a clean
  // token boundary (more digits than the 15-digit exact window, an
  // exponent, hex/inf/nan spellings, no digits at all) — strtod would
  // consume those bytes, so the fast result would disagree
  bool dirty_stop = (p < end && !is_space(*p) && *p != ':' && *p != ',' &&
                     *p != '\n');
  if (dirty_stop || idig + fdig == 0 || idig + fdig > 15) {
    p = s;
    return parse_num(p, end);
  }
  double v = (double)mant;
  if (fdig > 0) v /= kPow10[fdig];
  return neg ? -v : v;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// LibSVM:  "<label> <i>:<v> <i>:<v> ...\n"
// ---------------------------------------------------------------------------

// Pass 1: rows / nnz / max feature index (1-based input assumed by caller).
int svm_count(const char* buf, int64_t len, int64_t* out_rows,
              int64_t* out_nnz, int64_t* out_max_idx) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t rows = 0, nnz = 0, max_idx = 0;
  while (p < end) {
    while (p < end && (is_space(*p) || *p == '\n')) p++;
    if (p >= end) break;
    rows++;
    // skip label
    while (p < end && !is_space(*p) && *p != '\n') p++;
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) p++;
      if (p >= end || *p == '\n') break;
      long idx = parse_int(p, end);
      if (p < end && *p == ':') {
        p++;
        parse_num(p, end);
        nnz++;
        if (idx > max_idx) max_idx = idx;
      } else {
        while (p < end && !is_space(*p) && *p != '\n') p++;  // malformed tok
      }
    }
  }
  *out_rows = rows;
  *out_nnz = nnz;
  *out_max_idx = max_idx;
  return 0;
}

// Pass 2: fill labels (rows), indptr (rows+1), indices (nnz), values (nnz).
// start_index is subtracted from feature ids (LibSVM is 1-based).
int svm_fill(const char* buf, int64_t len, int64_t start_index,
             double* labels, int64_t* indptr, int32_t* indices,
             double* values) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, k = 0;
  indptr[0] = 0;
  while (p < end) {
    while (p < end && (is_space(*p) || *p == '\n')) p++;
    if (p >= end) break;
    // label = the ENTIRE first token (same token rule as svm_count: a
    // malformed "1:2" first token is all label, never feature pairs)
    {
      char lb[64];
      int n = 0;
      while (p < end && !is_space(*p) && *p != '\n' && n < 63) lb[n++] = *p++;
      while (p < end && !is_space(*p) && *p != '\n') p++;  // overlong tail
      lb[n] = '\0';
      labels[row] = std::strtod(lb, nullptr);
    }
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) p++;
      if (p >= end || *p == '\n') break;
      long idx = parse_int(p, end);
      if (p < end && *p == ':') {
        p++;
        double v = parse_num(p, end);
        indices[k] = (int32_t)(idx - start_index);
        values[k] = v;
        k++;
      } else {
        while (p < end && !is_space(*p) && *p != '\n') p++;
      }
    }
    row++;
    indptr[row] = k;
  }
  return 0;
}

// Fast one-pass protocol (the two-pass svm_count above parses every
// token twice — 2x the work for data that is parsed once and discarded):
// svm_bounds returns cheap memchr-counted UPPER bounds for allocation
// (rows <= #newlines+1, nnz <= #':'), svm_fill2 does the single real
// parse and reports the ACTUAL rows/nnz/max_idx so the caller trims.
int svm_bounds(const char* buf, int64_t len, int64_t* out_rows_ub,
               int64_t* out_nnz_ub) {
  // one auto-vectorized sweep counting both bytes at once — memchr per
  // hit was as slow as the real parse at one ':' every ~8 bytes
  int64_t nl = 0, colons = 0;
  for (int64_t i = 0; i < len; i++) {
    nl += (buf[i] == '\n');
    colons += (buf[i] == ':');
  }
  if (len > 0 && buf[len - 1] != '\n') nl++;
  *out_rows_ub = nl;
  *out_nnz_ub = colons;
  return 0;
}

int svm_fill2(const char* buf, int64_t len, int64_t start_index,
              double* labels, int64_t* indptr, int32_t* indices,
              double* values, int64_t* out_rows, int64_t* out_nnz,
              int64_t* out_max_idx) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, k = 0, max_idx = 0;
  indptr[0] = 0;
  while (p < end) {
    while (p < end && (is_space(*p) || *p == '\n')) p++;
    if (p >= end) break;
    // label = the ENTIRE first token (same rule as svm_count)
    {
      const char* tok = p;
      double v = parse_num_fast(p, end);
      // the token may extend past the parsed number (e.g. "1.5x"): the
      // label is strtod's prefix parse of the whole token, so re-parse
      // only if unconsumed non-separator bytes remain
      if (p < end && !is_space(*p) && *p != '\n') {
        char lb[64];
        int n = 0;
        const char* q = tok;
        while (q < end && !is_space(*q) && *q != '\n' && n < 63)
          lb[n++] = *q++;
        while (q < end && !is_space(*q) && *q != '\n') q++;
        lb[n] = '\0';
        v = std::strtod(lb, nullptr);
        p = q;
      }
      labels[row] = v;
    }
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) p++;
      if (p >= end || *p == '\n') break;
      long idx = parse_int(p, end);
      if (p < end && *p == ':') {
        p++;
        values[k] = parse_num_fast(p, end);
        indices[k] = (int32_t)(idx - start_index);
        if (idx > max_idx) max_idx = idx;
        k++;
      } else {
        while (p < end && !is_space(*p) && *p != '\n') p++;
      }
    }
    row++;
    indptr[row] = k;
  }
  *out_rows = row;
  *out_nnz = k;
  *out_max_idx = max_idx;
  return 0;
}

// Fused field-blocked fast path: for LibSVM rows that are EXACTLY one
// value-1.0 entry per field in field-major order (global idx =
// k*field_size + local + start_index for the k-th pair — the shape the
// field-aware FeatureHasher emits), parse straight into (rows, n_fields)
// int16 field-LOCAL ids + f32 labels in ONE pass. Writes 2-byte ids
// instead of 8-byte CSR indices and skips the separate subtract/cast
// encode pass entirely. Returns -1 on the first row that violates the
// shape so the caller can fall back to the generic CSR path.
int svm_fill_fb16(const char* buf, int64_t len, int64_t start_index,
                  int64_t n_fields, int64_t field_size,
                  float* labels, int16_t* fb, int64_t* out_rows) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  while (p < end) {
    while (p < end && (is_space(*p) || *p == '\n')) p++;
    if (p >= end) break;
    {
      const char* tok = p;
      double v = parse_num_fast(p, end);
      if (p < end && !is_space(*p) && *p != '\n') {
        char lb[64];
        int n = 0;
        const char* q = tok;
        while (q < end && !is_space(*q) && *q != '\n' && n < 63)
          lb[n++] = *q++;
        while (q < end && !is_space(*q) && *q != '\n') q++;
        lb[n] = '\0';
        v = std::strtod(lb, nullptr);
        p = q;
      }
      labels[row] = (float)v;
    }
    int64_t k = 0;
    int16_t* out = fb + row * n_fields;
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) p++;
      if (p >= end || *p == '\n') break;
      long idx = parse_int(p, end);
      if (p >= end || *p != ':') return -1;
      p++;
      double v = parse_num_fast(p, end);
      if (v != 1.0 || k >= n_fields) return -1;
      long local = idx - start_index - k * field_size;
      if (local < 0 || local >= field_size) return -1;
      out[k++] = (int16_t)local;
    }
    if (k != n_fields) return -1;
    row++;
  }
  *out_rows = row;
  return 0;
}

// ---------------------------------------------------------------------------
// Numeric CSV: rows of delimiter-separated numbers (no quoting — the
// general quoted/string path stays in Python's csv module).
// ---------------------------------------------------------------------------

int csv_dims(const char* buf, int64_t len, char delim, int64_t* out_rows,
             int64_t* out_cols) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t rows = 0, cols = 0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (line_end > p) {
      int64_t c = 1;
      for (const char* q = p; q < line_end; q++)
        if (*q == delim) c++;
      if (c > cols) cols = c;
      rows++;
    }
    p = line_end + 1;
  }
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

// Fill row-major (rows x cols); absent/empty cells become NaN.
int csv_fill(const char* buf, int64_t len, char delim, int64_t cols,
             double* out) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  const double nan = std::strtod("nan", nullptr);
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (line_end > p) {
      int64_t c = 0;
      const char* q = p;
      while (q <= line_end && c < cols) {
        const char* tok_end = q;
        while (tok_end < line_end && *tok_end != delim) tok_end++;
        if (tok_end > q) {
          char tmp[64];
          int n = (int)(tok_end - q < 63 ? tok_end - q : 63);
          std::memcpy(tmp, q, n);
          tmp[n] = '\0';
          char* endp;
          double v = std::strtod(tmp, &endp);
          out[row * cols + c] = (endp == tmp) ? nan : v;
        } else {
          out[row * cols + c] = nan;
        }
        c++;
        q = tok_end + 1;
      }
      for (; c < cols; c++) out[row * cols + c] = nan;
      row++;
    }
    p = line_end + 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched sparse-vector literals: one "$size$i:v i:v ..." or "i:v i:v"
// per \n-separated line (the reference "$4$0:1.5 3:2.0" format,
// VectorUtil.java). Criteo-style predict input parses through here.
// ---------------------------------------------------------------------------

int vec_count(const char* buf, int64_t len, int64_t* out_rows,
              int64_t* out_nnz, int64_t* out_max_idx) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t rows = 0, nnz = 0, max_idx = 0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (line_end > p) {
      rows++;
      const char* q = p;
      if (*q == '$') {  // "$size$"
        q++;
        long sz = parse_int(q, line_end);
        if (sz > max_idx) max_idx = sz;
        if (q < line_end && *q == '$') q++;
      }
      while (q < line_end) {
        while (q < line_end && is_sep(*q)) q++;
        if (q >= line_end) break;
        long idx = parse_int(q, line_end);
        if (q < line_end && *q == ':') {
          q++;
          parse_num(q, line_end);
          nnz++;
          if (idx + 1 > max_idx) max_idx = idx + 1;
        } else {
          while (q < line_end && !is_sep(*q)) q++;
        }
      }
    }
    p = line_end + 1;
  }
  *out_rows = rows;
  *out_nnz = nnz;
  *out_max_idx = max_idx;
  return 0;
}

// one-pass protocol for vector literals, mirroring svm_bounds/svm_fill2
int vec_bounds(const char* buf, int64_t len, int64_t* out_rows_ub,
               int64_t* out_nnz_ub) {
  return svm_bounds(buf, len, out_rows_ub, out_nnz_ub);
}

int vec_fill2(const char* buf, int64_t len, int64_t* indptr, int32_t* indices,
              double* values, int64_t* out_rows, int64_t* out_nnz,
              int64_t* out_max_idx) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, k = 0, max_idx = 0;
  indptr[0] = 0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (line_end > p) {
      const char* q = p;
      if (*q == '$') {  // "$size$"
        q++;
        long sz = parse_int(q, line_end);
        if (sz > max_idx) max_idx = sz;
        if (q < line_end && *q == '$') q++;
      }
      while (q < line_end) {
        while (q < line_end && is_sep(*q)) q++;
        if (q >= line_end) break;
        long idx = parse_int(q, line_end);
        if (q < line_end && *q == ':') {
          q++;
          values[k] = parse_num_fast(q, line_end);
          indices[k] = (int32_t)idx;
          if (idx + 1 > max_idx) max_idx = idx + 1;
          k++;
        } else {
          while (q < line_end && !is_sep(*q)) q++;
        }
      }
      row++;
      indptr[row] = k;
    }
    p = line_end + 1;
  }
  *out_rows = row;
  *out_nnz = k;
  *out_max_idx = max_idx;
  return 0;
}

int vec_fill(const char* buf, int64_t len, int64_t* indptr, int32_t* indices,
             double* values) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0, k = 0;
  indptr[0] = 0;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    if (line_end > p) {
      const char* q = p;
      if (*q == '$') {
        q++;
        parse_int(q, line_end);
        if (q < line_end && *q == '$') q++;
      }
      while (q < line_end) {
        while (q < line_end && is_sep(*q)) q++;
        if (q >= line_end) break;
        long idx = parse_int(q, line_end);
        if (q < line_end && *q == ':') {
          q++;
          values[k] = parse_num(q, line_end);
          indices[k] = (int32_t)idx;
          k++;
        } else {
          while (q < line_end && !is_sep(*q)) q++;
        }
      }
      row++;
      indptr[row] = k;
    }
    p = line_end + 1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// murmur_batch: MurmurHash3 x86 32-bit over a packed token buffer.
//
// The FeatureHasher host encode boundary (reference FeatureHasherMapper over
// Flink's murmur; FTRLExample.java:46-57) hashes one token per (row, column)
// cell — tens of millions of hashes on Criteo-scale inputs, far too slow for
// a per-token Python loop. Tokens arrive as one contiguous byte buffer with
// n+1 offsets; out[i] = murmur3_32(token_i, seed) % mod (mod <= 0 keeps the
// raw uint32 as a nonnegative int64-safe value stored in int64).
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h = seed;
  size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; i++) {
    uint32_t k;
    memcpy(&k, data + i * 4, 4);  // little-endian load
    k *= c1;
    k = rotl32(k, 15);
    k *= c2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (len & 3) {
    case 3: k ^= (uint32_t)tail[2] << 16; /* fallthrough */
    case 2: k ^= (uint32_t)tail[1] << 8;  /* fallthrough */
    case 1:
      k ^= tail[0];
      k *= c1;
      k = rotl32(k, 15);
      k *= c2;
      h ^= k;
  }
  h ^= (uint32_t)len;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

int64_t murmur_batch(const char* buf, const int64_t* offsets, int64_t n,
                     uint32_t seed, int64_t mod, int64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = (const uint8_t*)(buf + offsets[i]);
    size_t len = (size_t)(offsets[i + 1] - offsets[i]);
    uint32_t h = murmur3_32(p, len, seed);
    out[i] = (mod > 0) ? (int64_t)(h % (uint64_t)mod) : (int64_t)h;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ftrl_slot_run — the PINNED compiled single-slot CPU FTRL baseline.
//
// bench.py's `vs_baseline` stand-in for one Flink task-slot worker used to
// be a per-sample numpy loop re-measured every capture; its rate swung
// ±30-50% with host load and moved the strict-FTRL ratio across the 10x
// bar between otherwise identical rounds (VERDICT r5 #1). This is the same
// strict per-sample FTRL-proximal update as a compiled -O3 loop: no Python
// dispatch, no allocation, deterministic — measured best-of-N ONCE per rig
// and committed to BASELINE_compiled.json with the rig fingerprint, so
// `vs_baseline` is comparable round-over-round.
//
// Inputs are the padded COO micro-batch the device kernels consume
// (padding entries carry val == 0 and are algebraic no-ops: g = 0,
// sigma = 0, state unchanged). Two passes per row: the margin is computed
// at pre-update weights for EVERY slot (strict semantics), then the
// update is applied slot-by-slot.
int64_t ftrl_slot_run(const int32_t* idx, const double* val, const double* y,
                      int64_t rows, int64_t width, double alpha, double beta,
                      double l1, double l2, double* z, double* n) {
  for (int64_t i = 0; i < rows; i++) {
    const int32_t* ii = idx + i * width;
    const double* vv = val + i * width;
    double margin = 0.0;
    for (int64_t k = 0; k < width; k++) {
      double zi = z[ii[k]], ni = n[ii[k]];
      double decay = (beta + std::sqrt(ni)) / alpha + l2;
      double wi =
          (std::fabs(zi) <= l1) ? 0.0 : -(zi - std::copysign(l1, zi)) / decay;
      margin += wi * vv[k];
    }
    if (margin > 35.0) margin = 35.0;
    if (margin < -35.0) margin = -35.0;
    double c = 1.0 / (1.0 + std::exp(-margin)) - y[i];
    for (int64_t k = 0; k < width; k++) {
      int32_t j = ii[k];
      double v = vv[k];
      if (v == 0.0) continue;  // padding slot: exact no-op
      double zi = z[j], ni = n[j];
      double decay = (beta + std::sqrt(ni)) / alpha + l2;
      double wi =
          (std::fabs(zi) <= l1) ? 0.0 : -(zi - std::copysign(l1, zi)) / decay;
      double g = c * v;
      double sigma = (std::sqrt(ni + g * g) - std::sqrt(ni)) / alpha;
      z[j] = zi + g - sigma * wi;
      n[j] = ni + g * g;
    }
  }
  return 0;
}

}  // extern "C"
