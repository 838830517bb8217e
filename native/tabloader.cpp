// tabloader — native host-side tabular data pipeline.
//
// The input pipeline's host half: memory-mapped multithreaded CSV →
// float32 matrix parsing, in-place standardization, and deterministic
// shuffled epoch index generation.  The reference delegates data loading to
// MLUtils.DataLoader (pure Julia, single-threaded); for UCI-scale tabular
// density estimation (POWER ~2M rows, MINIBOONE 43 cols) the parse is the
// host bottleneck, so it lives in C++ behind a C ABI consumed via ctypes
// (`continuousnf_tpu/io/native_loader.py`).
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Table {
    float* data = nullptr;  // rows*cols, row-major
    int64_t rows = 0;
    int64_t cols = 0;
};

// Fast float parse for the common fixed-notation CSV case; falls back to
// strtof for exponents/specials.  `p` is advanced past the number.
inline float parse_float(const char*& p, const char* end) {
    const char* start = p;
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) {
        neg = (*p == '-');
        ++p;
    }
    double val = 0.0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        val = val * 10.0 + (*p - '0');
        ++p;
        any = true;
    }
    if (p < end && *p == '.') {
        ++p;
        double frac = 0.1;
        while (p < end && *p >= '0' && *p <= '9') {
            val += (*p - '0') * frac;
            frac *= 0.1;
            ++p;
            any = true;
        }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        // exponent: delegate to strtof from the start for correctness
        char* q = nullptr;
        float f = strtof(start, &q);
        p = q;
        return f;
    }
    if (!any) {  // NaN / inf / garbage — strtof handles the specials
        char* q = nullptr;
        float f = strtof(start, &q);
        if (q == start) {  // skip one char to guarantee progress
            ++p;
            return std::nanf("");
        }
        p = q;
        return f;
    }
    return neg ? -static_cast<float>(val) : static_cast<float>(val);
}

inline const char* next_line(const char* p, const char* end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    return nl ? nl + 1 : end;
}

int64_t count_cols(const char* p, const char* end, char delim) {
    int64_t cols = 1;
    while (p < end && *p != '\n') {
        if (*p == delim) ++cols;
        ++p;
    }
    return cols;
}

}  // namespace

extern "C" {

// Parse a headerless numeric CSV into a row-major float32 matrix.
// has_header skips the first line.  Returns an opaque handle (or nullptr).
void* tab_open_csv(const char* path, int has_header, char delim,
                   int64_t* out_rows, int64_t* out_cols) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
        close(fd);
        return nullptr;
    }
    const char* base =
        static_cast<const char*>(mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
    close(fd);
    if (base == MAP_FAILED) return nullptr;
    const char* end = base + st.st_size;

    const char* body = base;
    if (has_header) body = next_line(body, end);
    if (body >= end) {
        munmap(const_cast<char*>(base), st.st_size);
        return nullptr;
    }
    const int64_t cols = count_cols(body, end, delim);

    // Count data lines (non-empty).
    int64_t rows = 0;
    for (const char* p = body; p < end;) {
        const char* nl = next_line(p, end);
        if (nl - p > 1) ++rows;
        p = nl;
    }
    if (rows == 0) {
        munmap(const_cast<char*>(base), st.st_size);
        return nullptr;
    }

    auto* t = new Table();
    t->rows = rows;
    t->cols = cols;
    t->data = static_cast<float*>(malloc(sizeof(float) * rows * cols));

    // Partition the byte range across threads on line boundaries.
    const unsigned nthreads =
        std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
    std::vector<const char*> starts(nthreads + 1);
    starts[0] = body;
    for (unsigned i = 1; i < nthreads; ++i) {
        const char* guess = body + (end - body) * i / nthreads;
        starts[i] = guess < end ? next_line(guess, end) : end;
    }
    starts[nthreads] = end;

    // Pass 1 per chunk: count lines to find each chunk's output row offset.
    std::vector<int64_t> chunk_rows(nthreads, 0);
    std::vector<std::thread> workers;
    for (unsigned i = 0; i < nthreads; ++i) {
        workers.emplace_back([&, i] {
            int64_t r = 0;
            for (const char* p = starts[i]; p < starts[i + 1];) {
                const char* nl = next_line(p, starts[i + 1] < end ? end : end);
                if (nl > starts[i + 1]) nl = starts[i + 1];
                if (nl - p > 1) ++r;
                p = nl;
            }
            chunk_rows[i] = r;
        });
    }
    for (auto& w : workers) w.join();
    workers.clear();
    std::vector<int64_t> offsets(nthreads + 1, 0);
    for (unsigned i = 0; i < nthreads; ++i) offsets[i + 1] = offsets[i] + chunk_rows[i];

    // Pass 2: parse.
    for (unsigned i = 0; i < nthreads; ++i) {
        workers.emplace_back([&, i] {
            int64_t row = offsets[i];
            for (const char* p = starts[i]; p < starts[i + 1];) {
                const char* line_end =
                    static_cast<const char*>(memchr(p, '\n', starts[i + 1] - p));
                if (!line_end) line_end = starts[i + 1];
                if (line_end - p > 0) {
                    float* out = t->data + row * cols;
                    const char* q = p;
                    for (int64_t c = 0; c < cols; ++c) {
                        out[c] = parse_float(q, line_end);
                        while (q < line_end && *q != delim) ++q;
                        if (q < line_end) ++q;  // skip delim
                    }
                    ++row;
                }
                p = line_end + 1;
            }
        });
    }
    for (auto& w : workers) w.join();

    munmap(const_cast<char*>(base), st.st_size);
    *out_rows = t->rows;
    *out_cols = t->cols;
    return t;
}

const float* tab_data(void* handle) {
    return static_cast<Table*>(handle)->data;
}

// In-place per-column standardization; writes the column means/stds out.
void tab_standardize(void* handle, float* out_mean, float* out_std) {
    auto* t = static_cast<Table*>(handle);
    const int64_t R = t->rows, C = t->cols;
    std::vector<double> mean(C, 0.0), m2(C, 0.0);
    for (int64_t r = 0; r < R; ++r) {
        const float* row = t->data + r * C;
        for (int64_t c = 0; c < C; ++c) mean[c] += row[c];
    }
    for (int64_t c = 0; c < C; ++c) mean[c] /= R;
    for (int64_t r = 0; r < R; ++r) {
        const float* row = t->data + r * C;
        for (int64_t c = 0; c < C; ++c) {
            const double d = row[c] - mean[c];
            m2[c] += d * d;
        }
    }
    std::vector<float> inv_std(C);
    for (int64_t c = 0; c < C; ++c) {
        double sd = std::sqrt(m2[c] / R);
        if (sd < 1e-12) sd = 1.0;
        out_mean[c] = static_cast<float>(mean[c]);
        out_std[c] = static_cast<float>(sd);
        inv_std[c] = static_cast<float>(1.0 / sd);
    }
    for (int64_t r = 0; r < R; ++r) {
        float* row = t->data + r * C;
        for (int64_t c = 0; c < C; ++c) row[c] = (row[c] - out_mean[c]) * inv_std[c];
    }
}

void tab_close(void* handle) {
    auto* t = static_cast<Table*>(handle);
    free(t->data);
    delete t;
}

// Deterministic Fisher–Yates shuffle of [0, n) (splitmix64 RNG) — the epoch
// permutation for host-side loaders, keyed like jax.random.fold_in.
void tab_shuffle_indices(uint64_t seed, int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = i;
    uint64_t s = seed + 0x9e3779b97f4a7c15ULL;
    auto next = [&s]() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
        return z ^ (z >> 31);
    };
    for (int64_t i = n - 1; i > 0; --i) {
        const int64_t j = static_cast<int64_t>(next() % static_cast<uint64_t>(i + 1));
        const int64_t tmp = out[i];
        out[i] = out[j];
        out[j] = tmp;
    }
}

}  // extern "C"
