// Native EuRoC CSV loader + sensor ring buffer (the port's copy of the JAX
// package's native/euroc_loader.cpp).
//
// The host-side path that feeds the device pipeline parses timestamps and
// buckets IMU samples over CSVs of millions of rows; numpy's loadtxt is
// ~10x slower and allocates per line. Built with the host's C++ compiler at
// first use and bound through ctypes (larvio_tpu_torch/utils/native.py).
//
// Build: c++ -O3 -shared -fPIC euroc_loader.cpp -o libeuroc.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// fast strtod-based line parser; returns number of fields parsed
inline int parse_line(const char* s, double* out, int max_cols) {
    int n = 0;
    while (*s && n < max_cols) {
        char* end = nullptr;
        double v = strtod(s, &end);
        if (end == s) break;
        out[n++] = v;
        s = end;
        while (*s == ',' || *s == ' ' || *s == '\t') ++s;
    }
    return n;
}

struct FileBuf {
    char* data = nullptr;
    size_t size = 0;
    ~FileBuf() { free(data); }
    bool read(const char* path) {
        FILE* f = fopen(path, "rb");
        if (!f) return false;
        fseek(f, 0, SEEK_END);
        long sz = ftell(f);
        fseek(f, 0, SEEK_SET);
        data = static_cast<char*>(malloc(sz + 1));
        size = fread(data, 1, sz, f);
        data[size] = '\0';
        fclose(f);
        return true;
    }
};

}  // namespace

extern "C" {

// Count data rows (non-comment, non-empty) in a CSV file. -1 on error.
long euroc_csv_count_rows(const char* path) {
    FileBuf buf;
    if (!buf.read(path)) return -1;
    long rows = 0;
    const char* p = buf.data;
    while (p && *p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p && *p != '#' && *p != '\n' && *p != '\r') ++rows;
        p = strchr(p, '\n');
        if (p) ++p;
    }
    return rows;
}

// Load up to max_rows x n_cols doubles. Returns rows loaded; -1 on error.
long euroc_csv_load(const char* path, int n_cols, double* out, long max_rows) {
    FileBuf buf;
    if (!buf.read(path)) return -1;
    long rows = 0;
    const char* p = buf.data;
    while (p && *p && rows < max_rows) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p && *p != '#' && *p != '\n' && *p != '\r') {
            if (parse_line(p, out + rows * n_cols, n_cols) == n_cols) ++rows;
        }
        p = strchr(p, '\n');
        if (p) ++p;
    }
    return rows;
}

// ---------------------------------------------------------------------------
// Streaming sensor synchronizer: a lock-free-ish ring buffer of IMU samples
// plus per-frame bucketing (the host-side runtime the reference implements
// with std::vector buffers inside its ROS/system wrapper).
// ---------------------------------------------------------------------------

struct ImuRing {
    std::vector<double> t;
    std::vector<double> w;  // 3x
    std::vector<double> a;  // 3x
    size_t head = 0, count = 0, cap = 0;
};

void* imu_ring_create(long capacity) {
    auto* r = new ImuRing();
    r->cap = capacity;
    r->t.resize(capacity);
    r->w.resize(capacity * 3);
    r->a.resize(capacity * 3);
    return r;
}

void imu_ring_destroy(void* ring) { delete static_cast<ImuRing*>(ring); }

void imu_ring_push(void* ring, double t, const double* w, const double* a) {
    auto* r = static_cast<ImuRing*>(ring);
    size_t idx = (r->head + r->count) % r->cap;
    if (r->count == r->cap) {
        r->head = (r->head + 1) % r->cap;  // overwrite oldest
        idx = (r->head + r->count - 1) % r->cap;
    } else {
        ++r->count;
    }
    r->t[idx] = t;
    memcpy(&r->w[idx * 3], w, 3 * sizeof(double));
    memcpy(&r->a[idx * 3], a, 3 * sizeof(double));
}

// Fill a fixed-slot frame bucket: one sample at/before t_prev, then samples
// up to t_img + margin. Returns the number of valid slots.
long imu_ring_bucket(void* ring, double t_prev, double t_img, double margin,
                     long slots, float* out_t, float* out_w, float* out_a,
                     uint8_t* out_valid) {
    auto* r = static_cast<ImuRing*>(ring);
    memset(out_valid, 0, slots);
    long n = 0;
    long start = -1;
    // find last sample <= t_prev
    for (size_t i = 0; i < r->count; ++i) {
        size_t idx = (r->head + i) % r->cap;
        if (r->t[idx] <= t_prev) start = static_cast<long>(i);
        else break;
    }
    if (start < 0) start = 0;
    for (size_t i = start; i < r->count && n < slots; ++i) {
        size_t idx = (r->head + i) % r->cap;
        if (r->t[idx] > t_img + margin) break;
        out_t[n] = static_cast<float>(r->t[idx]);
        for (int k = 0; k < 3; ++k) {
            out_w[n * 3 + k] = static_cast<float>(r->w[idx * 3 + k]);
            out_a[n * 3 + k] = static_cast<float>(r->a[idx * 3 + k]);
        }
        out_valid[n] = 1;
        ++n;
    }
    return n;
}

}  // extern "C"
