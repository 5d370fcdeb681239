// Fast MatrixMarket coordinate reader (C ABI, loaded via ctypes).
//
// The reference's IO path is native C++ (MatrixUtils::mmread,
// reference src/HYMLS_MatrixUtils.cpp); scipy's pure-Python reader
// takes tens of seconds on the ~50MB driven-cavity Jacobian files.
// This reader memory-maps nothing fancy: one buffered pass with
// strtol/strtod, ~100x faster.
//
// Exposed functions:
//   mm_count(path, &n_rows, &n_cols, &nnz, &is_symmetric, &is_pattern)
//     -> 0 on success
//   mm_read(path, rows*, cols*, vals*, nnz) -> entries read, or -1
//
// Build: g++ -O3 -shared -fPIC -o _mmio.so mmio.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>

extern "C" {

static int read_header(FILE* f, long* n_rows, long* n_cols, long* nnz,
                       int* symmetric, int* pattern) {
    char line[1024];
    if (!fgets(line, sizeof line, f)) return -1;
    if (strncmp(line, "%%MatrixMarket", 14) != 0) return -2;
    *symmetric = (strstr(line, "symmetric") != nullptr) ||
                 (strstr(line, "skew-symmetric") != nullptr);
    *pattern = strstr(line, "pattern") != nullptr;
    // skip comments
    long r = 0, c = 0, z = 0;
    while (fgets(line, sizeof line, f)) {
        if (line[0] == '%') continue;
        if (sscanf(line, "%ld %ld %ld", &r, &c, &z) == 3) {
            *n_rows = r; *n_cols = c; *nnz = z;
            return 0;
        }
        if (sscanf(line, "%ld %ld", &r, &c) == 2) {
            // dense array format: rows cols
            *n_rows = r; *n_cols = c; *nnz = -1;
            return 1;
        }
        return -3;
    }
    return -4;
}

int mm_count(const char* path, long* n_rows, long* n_cols, long* nnz,
             int* symmetric, int* pattern) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    int ret = read_header(f, n_rows, n_cols, nnz, symmetric, pattern);
    fclose(f);
    return ret;
}

// Coordinate entries; returns number of entries read or negative error.
long mm_read(const char* path, int64_t* rows, int64_t* cols, double* vals,
             long max_entries) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    long n_rows, n_cols, nnz;
    int symmetric, pattern;
    int hdr = read_header(f, &n_rows, &n_cols, &nnz, &symmetric, &pattern);
    if (hdr != 0) { fclose(f); return -2; }

    static const size_t BUF = 1 << 20;
    char* buf = (char*)malloc(BUF);
    long k = 0;
    size_t have = 0;
    size_t off = 0;
    bool eof = false;
    while (k < max_entries) {
        // refill keeping the tail partial line
        if (!eof) {
            memmove(buf, buf + off, have - off);
            have -= off;
            off = 0;
            size_t got = fread(buf + have, 1, BUF - have - 1, f);
            have += got;
            buf[have] = '\0';
            if (got == 0) eof = true;
        }
        if (have == off) break;
        // parse complete lines in the buffer
        char* p = buf + off;
        char* endbuf = buf + have;
        while (p < endbuf && k < max_entries) {
            // find end of line
            char* nl = (char*)memchr(p, '\n', endbuf - p);
            if (!nl && !eof) break;   // partial line; refill
            char* q;
            long r = strtol(p, &q, 10);
            if (q == p) { p = nl ? nl + 1 : endbuf; continue; }
            long c = strtol(q, &q, 10);
            double v = pattern ? 1.0 : strtod(q, &q);
            rows[k] = r - 1;
            cols[k] = c - 1;
            vals[k] = v;
            ++k;
            p = nl ? nl + 1 : endbuf;
        }
        off = p - buf;
        if (eof && p >= endbuf) break;
    }
    free(buf);
    fclose(f);
    return k;
}

// Dense MatrixMarket "array" format: column-major values.
long mm_read_array(const char* path, double* vals, long max_entries) {
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    long n_rows, n_cols, nnz;
    int symmetric, pattern;
    int hdr = read_header(f, &n_rows, &n_cols, &nnz, &symmetric, &pattern);
    if (hdr != 1) { fclose(f); return -2; }
    long total = n_rows * n_cols;
    if (total > max_entries) total = max_entries;
    long k = 0;
    double v;
    while (k < total && fscanf(f, "%lf", &v) == 1) vals[k++] = v;
    fclose(f);
    return k;
}

}  // extern "C"
