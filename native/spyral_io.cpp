// Native Spyral assembly + HDF5 writer for the out-of-process writer child.
//
// The writer child (attpc_engine_tpu/io/spyral_child.py) shares the host's
// cores with the parent that drives the device.  This module moves the
// child's entire per-batch CPU pipeline into C++:
//
//   * sio_wiggle       — the per-event TB wiggle stream, bit-exact to
//                        numpy.random.Generator(Philox(key=[seed, event]))
//                        .random(n)  (Philox4x64-10, counter pre-increment,
//                        (x >> 11) * 2^-53 double conversion),
//   * sio_assemble_batch — packed 8-byte device rows -> per-event stable
//                        z-sort (descending wiggled tb) -> Spyral [n, 8]
//                        f64 rows + i64 labels, same IEEE op order as
//                        DetectorSimulator.assemble_spyral so the output
//                        stays value-identical to the in-process writer
//                        (reference math: attpc_engine detector/writer.py
//                        get_response/convert semantics),
//   * sio_h5_*         — per-event cloud_N/labels_N dataset + attribute
//                        writes through libhdf5's C API, dlopen'd from
//                        h5py's bundled shared object (this image has no
//                        HDF5 headers; the 1.14 C ABI below is stable).
//
// Everything stays value-identical to the pure-Python child path; the
// Python side keeps file rotation / empty-event bookkeeping and falls back
// to numpy+h5py when this library is unavailable
// (tests/test_native.py::test_spyral_io_* checks exactness).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libspyral_io.so spyral_io.cpp -ldl

#include <algorithm>
#include <cstdint>
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <fcntl.h>
#include <unistd.h>
#include <vector>

// ---------------------------------------------------------------------------
// Philox4x64-10 (Random123 constants), matching numpy's bit generator.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t M0 = 0xD2E7470EE14C6C93ULL;
constexpr uint64_t M1 = 0xCA5A826395121157ULL;
constexpr uint64_t W0 = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t W1 = 0xBB67AE8584CAA73BULL;

inline void mulhilo(uint64_t a, uint64_t b, uint64_t& hi, uint64_t& lo) {
    __uint128_t p = static_cast<__uint128_t>(a) * b;
    hi = static_cast<uint64_t>(p >> 64);
    lo = static_cast<uint64_t>(p);
}

struct Philox4x64 {
    uint64_t ctr[4];
    uint64_t key[2];

    void block(uint64_t out[4]) const {
        uint64_t c0 = ctr[0], c1 = ctr[1], c2 = ctr[2], c3 = ctr[3];
        uint64_t k0 = key[0], k1 = key[1];
        for (int r = 0; r < 10; ++r) {
            if (r > 0) { k0 += W0; k1 += W1; }
            uint64_t hi0, lo0, hi1, lo1;
            mulhilo(M0, c0, hi0, lo0);
            mulhilo(M1, c2, hi1, lo1);
            c0 = hi1 ^ c1 ^ k0;
            c1 = lo1;
            c2 = hi0 ^ c3 ^ k1;
            c3 = lo0;
        }
        out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
    }

    // numpy's philox_next: the 256-bit counter increments BEFORE each block
    void advance_ctr() {
        if (++ctr[0] != 0) return;
        if (++ctr[1] != 0) return;
        if (++ctr[2] != 0) return;
        ++ctr[3];
    }
};

}  // namespace

extern "C" void sio_wiggle(uint64_t seed, uint64_t event, int64_t n,
                           double* out) {
    // numpy: np.random.Generator(np.random.Philox(key=[seed, event]))
    //        .random(n)  — key taken verbatim (no SeedSequence), counter 0,
    //        doubles = (next_uint64 >> 11) * (1 / 2^53)
    Philox4x64 st{{0, 0, 0, 0}, {seed, event}};
    constexpr double SCALE = 1.0 / 9007199254740992.0;  // 2^-53
    uint64_t buf[4];
    int64_t i = 0;
    while (i < n) {
        st.advance_ctr();
        st.block(buf);
        for (int j = 0; j < 4 && i < n; ++j, ++i)
            out[i] = static_cast<double>(buf[j] >> 11) * SCALE;
    }
}

// ---------------------------------------------------------------------------
// Batch assembly: packed device rows -> sorted Spyral pool.
// ---------------------------------------------------------------------------

extern "C" void sio_assemble_batch(
    const int32_t* packed,      // [rows, 2]: (f32 charge bits, meta)
    int64_t rows,
    const int64_t* counts,      // [nevents] kept rows per event
    int64_t nevents,
    int64_t start_event,
    uint64_t wseed,
    const double* pad_cx,       // [n_pads]
    const double* pad_cy,
    const double* pad_sizes,
    const double* resp_asc,     // [num_tb] ascending response samples
    const double* resp_prefix,  // [num_tb + 1] prefix sums of resp_asc
    int64_t num_tb,
    double resp_max,
    double windows_edge,
    double micromegas_edge,
    double length_m,
    double* out_spyral,         // [rows, 8]
    int64_t* out_labels) {      // [rows]
    (void)rows;
    const double z_denom = windows_edge - micromegas_edge;
    std::vector<double> tbf;
    std::vector<int32_t> tbi;
    std::vector<int32_t> order;
    int64_t lo = 0;
    for (int64_t e = 0; e < nevents; ++e) {
        const int64_t n = counts[e];
        if (n == 0) continue;
        // per-event wiggle stream (device rows arrive pre-sorted by
        // descending INTEGER tb; the wiggle breaks the remaining ties
        // exactly like the reference's z argsort over wiggled tbs)
        tbf.resize(n);
        tbi.resize(n);
        sio_wiggle(wseed, static_cast<uint64_t>(start_event + e), n,
                   tbf.data());
        bool descending = true;
        for (int64_t i = 0; i < n; ++i) {
            const int32_t tb_int = packed[2 * (lo + i) + 1] >> 22;
            tbi[i] = tb_int;
            if (i && tb_int > tbi[i - 1]) descending = false;
            tbf[i] += static_cast<double>(tb_int);
        }
        // stable argsort by descending wiggled tb == np.argsort(-tbf,
        // kind="stable"). When the integer tbs arrive descending (always,
        // from the device's output sort), the global sort decomposes into
        // independent stable sorts of each equal-tb run: integer tbs
        // differ by >= 1 while the wiggle lies in [0, 1), so cross-run
        // order is already final. Runs are short (an event's rows spread
        // over <= 512 tbs), collapsing n*log(n) comparator work to
        // ~n*log(run_len); any precondition violation falls back to the
        // full sort — bit-identical output either way.
        order.resize(n);
        for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
        const auto desc = [&](int32_t a, int32_t b) { return tbf[a] > tbf[b]; };
        if (descending) {
            int64_t a = 0;
            while (a < n) {
                int64_t b = a + 1;
                while (b < n && tbi[b] == tbi[a]) ++b;
                const int64_t r = b - a;
                if (r > 32) {
                    std::stable_sort(order.begin() + a, order.begin() + b,
                                     desc);
                } else if (r > 1) {
                    // stable insertion sort (descending tbf): equal keys
                    // never cross a strictly-smaller predecessor, so the
                    // original order of ties is preserved exactly like
                    // std::stable_sort — without the temporary-buffer
                    // allocation std::stable_sort performs on EVERY call
                    // (~500 run-sized calls per event at run length ~6,
                    // measured 5% SLOWER than the full event sort)
                    for (int64_t i = a + 1; i < b; ++i) {
                        const int32_t v = order[i];
                        const double key = tbf[v];
                        int64_t j = i;
                        while (j > a && tbf[order[j - 1]] < key) {
                            order[j] = order[j - 1];
                            --j;
                        }
                        order[j] = v;
                    }
                }
                a = b;
            }
        } else {
            std::stable_sort(order.begin(), order.end(), desc);
        }
        for (int64_t i = 0; i < n; ++i) {
            const int64_t s = lo + order[i];
            int32_t qbits = packed[2 * s];
            float qf;
            std::memcpy(&qf, &qbits, sizeof(float));
            const int32_t meta = packed[2 * s + 1];
            const int32_t pad = (meta >> 8) & 0x3FFF;
            const int32_t lab = meta & 0xFF;
            const double q = static_cast<double>(qf);
            // identical IEEE op order to spyral_child.assemble /
            // DetectorSimulator.assemble_spyral — do not reassociate
            const double thr = 4095.0 / std::max(q, 1e-300);
            const int64_t idx =
                std::upper_bound(resp_asc, resp_asc + num_tb, thr) - resp_asc;
            double integral = q * resp_prefix[idx];
            integral += 4095.0 * static_cast<double>(num_tb - idx);
            const double amp = std::min(q * resp_max, 4095.0);
            const double tb = tbf[order[i]];
            double z = windows_edge - tb;
            z /= z_denom;
            z *= length_m;
            z *= 1000.0;
            double* row = out_spyral + 8 * (lo + i);
            row[0] = pad_cx[pad];
            row[1] = pad_cy[pad];
            row[2] = z;
            row[3] = amp;
            row[4] = integral;
            row[5] = static_cast<double>(pad);
            row[6] = tb;
            row[7] = pad_sizes[pad];
            out_labels[lo + i] = lab;
        }
        lo += n;
    }
}

// ---------------------------------------------------------------------------
// HDF5 writer through the dlopen'd 1.14 C API (h5py's bundled libhdf5).
// ---------------------------------------------------------------------------

namespace {

using hid = int64_t;     // hid_t in HDF5 >= 1.10
using herr = int;        // herr_t
using hsize = uint64_t;  // hsize_t

constexpr hid H5P_DEFAULT_ = 0;
constexpr hid H5S_ALL_ = 0;
constexpr unsigned H5F_ACC_TRUNC_ = 0x0002u;
constexpr int H5S_SCALAR_ = 0;  // H5S_class_t

struct H5Api {
    herr (*open)();
    hid (*fcreate)(const char*, unsigned, hid, hid);
    herr (*fclose)(hid);
    hid (*gcreate2)(hid, const char*, hid, hid, hid);
    herr (*gclose)(hid);
    hid (*screate_simple)(int, const hsize*, const hsize*);
    hid (*screate)(int);
    herr (*sclose)(hid);
    hid (*dcreate2)(hid, const char*, hid, hid, hid, hid, hid);
    herr (*dwrite)(hid, hid, hid, hid, hid, const void*);
    herr (*dclose)(hid);
    hid (*acreate2)(hid, const char*, hid, hid, hid, hid);
    herr (*awrite)(hid, hid, const void*);
    herr (*aclose)(hid);
    // in-memory (core VFD) image writer — optional, see sio_h5_open_mem
    hid (*pcreate)(hid) = nullptr;
    herr (*pclose)(hid) = nullptr;
    herr (*set_fapl_core)(hid, size_t, unsigned) = nullptr;
    int64_t (*get_file_image)(hid, void*, size_t) = nullptr;  // ssize_t
    herr (*fflush)(hid, int) = nullptr;
    // optional: new-format files (dense attrs + fractal-heap links) —
    // the per-event metadata cost is the measured writer-child floor
    herr (*set_libver)(hid, int, int) = nullptr;
    hid cls_facc = -1;
    hid t_f64le = -1, t_i64le = -1, t_nat_f64 = -1, t_nat_i64 = -1;
    hid s_scalar = -1;
    bool ready = false;
    bool mem_ready = false;
};

H5Api g_h5;

template <typename T>
bool resolve(void* lib, const char* name, T& fn) {
    fn = reinterpret_cast<T>(dlsym(lib, name));
    return fn != nullptr;
}

hid global_hid(void* lib, const char* name) {
    // the H5T_* "types" are exported global hid_t variables, valid after
    // H5open()
    auto* p = reinterpret_cast<hid*>(dlsym(lib, name));
    return p ? *p : -1;
}

struct Writer {
    hid file = -1;
    hid group = -1;
};

}  // namespace

extern "C" int sio_h5_init(const char* libpath) {
    if (g_h5.ready) return 0;
    void* lib = dlopen(libpath, RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return -1;
    bool ok = resolve(lib, "H5open", g_h5.open) &&
              resolve(lib, "H5Fcreate", g_h5.fcreate) &&
              resolve(lib, "H5Fclose", g_h5.fclose) &&
              resolve(lib, "H5Gcreate2", g_h5.gcreate2) &&
              resolve(lib, "H5Gclose", g_h5.gclose) &&
              resolve(lib, "H5Screate_simple", g_h5.screate_simple) &&
              resolve(lib, "H5Screate", g_h5.screate) &&
              resolve(lib, "H5Sclose", g_h5.sclose) &&
              resolve(lib, "H5Dcreate2", g_h5.dcreate2) &&
              resolve(lib, "H5Dwrite", g_h5.dwrite) &&
              resolve(lib, "H5Dclose", g_h5.dclose) &&
              resolve(lib, "H5Acreate2", g_h5.acreate2) &&
              resolve(lib, "H5Awrite", g_h5.awrite) &&
              resolve(lib, "H5Aclose", g_h5.aclose);
    if (!ok || g_h5.open() < 0) return -2;
    g_h5.t_f64le = global_hid(lib, "H5T_IEEE_F64LE_g");
    g_h5.t_i64le = global_hid(lib, "H5T_STD_I64LE_g");
    g_h5.t_nat_f64 = global_hid(lib, "H5T_NATIVE_DOUBLE_g");
    g_h5.t_nat_i64 = global_hid(lib, "H5T_NATIVE_INT64_g");
    if (g_h5.t_nat_i64 < 0)
        g_h5.t_nat_i64 = global_hid(lib, "H5T_NATIVE_LLONG_g");
    if (g_h5.t_f64le < 0 || g_h5.t_i64le < 0 || g_h5.t_nat_f64 < 0 ||
        g_h5.t_nat_i64 < 0)
        return -3;
    g_h5.s_scalar = g_h5.screate(H5S_SCALAR_);
    if (g_h5.s_scalar < 0) return -4;
    g_h5.ready = true;
    // optional core-VFD image writer (all 1.8+ APIs; degrade gracefully)
    bool mem_ok = resolve(lib, "H5Pcreate", g_h5.pcreate) &&
                  resolve(lib, "H5Pclose", g_h5.pclose) &&
                  resolve(lib, "H5Pset_fapl_core", g_h5.set_fapl_core) &&
                  resolve(lib, "H5Fget_file_image", g_h5.get_file_image) &&
                  resolve(lib, "H5Fflush", g_h5.fflush);
    if (mem_ok) {
        g_h5.cls_facc = global_hid(lib, "H5P_CLS_FILE_ACCESS_ID_g");
        mem_ok = g_h5.cls_facc >= 0;
    }
    g_h5.mem_ready = mem_ok;
    resolve(lib, "H5Pset_libver_bounds", g_h5.set_libver);  // optional
    return 0;
}

// ---------------------------------------------------------------------------
// New-format (libver >= 1.8) file creation. The writer child's measured
// floor on a warm-page epoch is per-event HDF5 METADATA CPU (~2.4 ms/event
// for 2 datasets + 6 attrs in old-format storage: symbol-table b-tree link
// inserts + non-dense attribute messages). The 1.8 object-header format
// stores the same objects with dense attributes and fractal-heap links.
// Files remain readable by any h5py/HDF5 >= 1.8 (the Spyral contract is
// h5py-level, not byte-level). Opt-in via sio_h5_set_latest(1) so the
// default output stays byte-compatible with earlier rounds.
// ---------------------------------------------------------------------------

namespace {
bool g_use_latest = false;

// fapl for file creation honoring the latest-format toggle, or
// H5P_DEFAULT_ when off/unavailable. Caller must pclose() when >= 0.
hid make_fapl() {
    if (!g_use_latest || !g_h5.set_libver || !g_h5.pcreate ||
        g_h5.cls_facc < 0)
        return H5P_DEFAULT_;
    hid fapl = g_h5.pcreate(g_h5.cls_facc);
    if (fapl < 0) return H5P_DEFAULT_;
    // H5F_LIBVER_V18 = 1 as low and high: dense attrs + new object
    // headers with maximum reader compatibility (everything >= 1.8)
    if (g_h5.set_libver(fapl, 1, 1) < 0) {
        g_h5.pclose(fapl);
        return H5P_DEFAULT_;
    }
    return fapl;
}
}  // namespace

extern "C" void sio_h5_set_latest(int on) { g_use_latest = on != 0; }

extern "C" void* sio_h5_open(const char* path) {
    if (!g_h5.ready) return nullptr;
    hid fapl = make_fapl();
    hid f = g_h5.fcreate(path, H5F_ACC_TRUNC_, H5P_DEFAULT_, fapl);
    if (fapl != H5P_DEFAULT_) g_h5.pclose(fapl);
    if (f < 0) return nullptr;
    hid g = g_h5.gcreate2(f, "cloud", H5P_DEFAULT_, H5P_DEFAULT_,
                          H5P_DEFAULT_);
    if (g < 0) {
        g_h5.fclose(f);
        return nullptr;
    }
    return new Writer{f, g};
}

namespace {

int attr_i64(hid oid, const char* name, int64_t value) {
    hid a = g_h5.acreate2(oid, name, g_h5.t_i64le, g_h5.s_scalar,
                          H5P_DEFAULT_, H5P_DEFAULT_);
    if (a < 0) return -1;
    herr rc = g_h5.awrite(a, g_h5.t_nat_i64, &value);
    g_h5.aclose(a);
    return rc < 0 ? -1 : 0;
}

int attr_f64(hid oid, const char* name, double value) {
    hid a = g_h5.acreate2(oid, name, g_h5.t_f64le, g_h5.s_scalar,
                          H5P_DEFAULT_, H5P_DEFAULT_);
    if (a < 0) return -1;
    herr rc = g_h5.awrite(a, g_h5.t_nat_f64, &value);
    g_h5.aclose(a);
    return rc < 0 ? -1 : 0;
}

}  // namespace

extern "C" int sio_h5_write_event(void* handle, int64_t run_number,
                                  int64_t event_number, const double* spyral,
                                  int64_t nrows, const int64_t* labels) {
    auto* w = static_cast<Writer*>(handle);
    if (!w || !g_h5.ready) return -1;
    char name[32];

    hsize dims2[2] = {static_cast<hsize>(nrows), 8};
    hid space = g_h5.screate_simple(2, dims2, nullptr);
    std::snprintf(name, sizeof(name), "cloud_%lld",
                  static_cast<long long>(event_number));
    hid d = g_h5.dcreate2(w->group, name, g_h5.t_f64le, space, H5P_DEFAULT_,
                          H5P_DEFAULT_, H5P_DEFAULT_);
    g_h5.sclose(space);
    if (d < 0) return -2;
    int rc = 0;
    if (nrows > 0 &&
        g_h5.dwrite(d, g_h5.t_nat_f64, H5S_ALL_, H5S_ALL_, H5P_DEFAULT_,
                    spyral) < 0)
        rc = -3;
    rc |= attr_i64(d, "orig_run", run_number);
    rc |= attr_i64(d, "orig_event", event_number);
    rc |= attr_f64(d, "ic_amplitude", -1.0);
    rc |= attr_f64(d, "ic_multiplicity", -1.0);
    rc |= attr_f64(d, "ic_integral", -1.0);
    rc |= attr_f64(d, "ic_centroid", -1.0);
    g_h5.dclose(d);

    hsize dims1[1] = {static_cast<hsize>(nrows)};
    space = g_h5.screate_simple(1, dims1, nullptr);
    std::snprintf(name, sizeof(name), "labels_%lld",
                  static_cast<long long>(event_number));
    d = g_h5.dcreate2(w->group, name, g_h5.t_i64le, space, H5P_DEFAULT_,
                      H5P_DEFAULT_, H5P_DEFAULT_);
    g_h5.sclose(space);
    if (d < 0) return -4;
    if (nrows > 0 &&
        g_h5.dwrite(d, g_h5.t_nat_i64, H5S_ALL_, H5S_ALL_, H5P_DEFAULT_,
                    labels) < 0)
        rc = -5;
    g_h5.dclose(d);
    return rc;
}

extern "C" int64_t sio_h5_write_events(void* handle, int64_t run_number,
                                       int64_t start_event,
                                       const int64_t* counts,
                                       const int64_t* raw_counts,
                                       int64_t nevents, const double* spyral,
                                       const int64_t* labels) {
    // Bulk twin of sio_h5_write_event over a rotation-free segment:
    // events with counts[e] == 0 are SKIPPED when raw_counts says they
    // were raw-empty, and written as EMPTY datasets when their points all
    // failed the ADC threshold (reference SpyralWriter parity — the
    // caller, ChildWriter.write_batch_native, pre-splits batches at file
    // rotation boundaries). Returns events written, or < 0 on error.
    int64_t off = 0;
    int64_t written = 0;
    for (int64_t e = 0; e < nevents; ++e) {
        const int64_t n = counts[e];
        if (n == 0 && (raw_counts == nullptr || raw_counts[e] == 0))
            continue;
        int rc = sio_h5_write_event(handle, run_number, start_event + e,
                                    n ? spyral + 8 * off : nullptr, n,
                                    n ? labels + off : nullptr);
        if (rc != 0) return rc;
        ++written;
        off += n;
    }
    return written;
}

extern "C" int sio_h5_close(void* handle, int64_t min_event,
                            int64_t max_event) {
    auto* w = static_cast<Writer*>(handle);
    if (!w) return -1;
    int rc = 0;
    rc |= attr_i64(w->group, "min_event", min_event);
    rc |= attr_i64(w->group, "max_event", max_event);
    g_h5.gclose(w->group);
    if (g_h5.fclose(w->file) < 0) rc = -2;
    delete w;
    return rc;
}

// ---------------------------------------------------------------------------
// In-memory (core VFD) file writing + pwrite materialization.
//
// Motivation (measured on the dev VM, BASELINE.md "page-fault tax"): every
// FIRST touch of a page costs a fluctuating 8-35 us hypervisor fault, so
// writing a 1.1 GB run file through the sec2 VFD pays minutes of kernel
// time per 1M-event run, while REWRITING existing (warm) pages runs at
// ~3.9 GB/s.  sio_h5_open_mem builds the HDF5 file in the core (memory)
// VFD — whose buffer lives in the (warm, reused) heap — and
// sio_h5_close_mem materializes the finished image with ONE pwrite into
// the destination path WITHOUT O_TRUNC, so a recycled destination file
// (renamed from a pruned predecessor) keeps its already-faulted pages and
// the write runs at memory speed.  With a fresh destination the tax is
// paid once, same as sec2 — callers should prefer recycled destinations
// (ChildWriter rotates through <outdir>/.recycle when present).
// ---------------------------------------------------------------------------

namespace {

// Grow-only extraction arena: H5Fget_file_image copies the finished
// image here, so the copy target's pages are warm after the first file.
// (Intercepting the core VFD's own buffer via file-image callbacks was
// tried and REVERTED: HDF5 1.14's core driver does not route its buffer
// free through them, which dangles the arena and silently reuses the
// previous file's image — all run files came out identical.)
std::vector<char>& arena() {
    static std::vector<char> a;
    return a;
}

// Core-VFD buffer increment. Must fit the whole run file (growth is a
// whole-image realloc onto fresh pages — measured 10x slower than sec2)
// and stay below INT_MAX so the raised M_MMAP_THRESHOLD (an int mallopt,
// see spyral_child.tune_malloc) keeps glibc serving and reusing it from
// the warm heap across files.
constexpr size_t kCoreIncrement = (size_t)1536 << 20;

// Holder for the core VFD's freed buffer chunk between files. Without
// it, any small malloc between one file's close and the next file's
// create can SPLIT the freed 1.5 GB chunk in glibc's bins, so the next
// file's buffer lands on fresh (cold, fault-taxed) pages — measured as
// 28-63 s per rotation in the writer child while a tight microbench
// (no intervening allocations) reused the chunk warm at ~0.2 s.
// close_mem captures the chunk the instant HDF5 frees it; open_mem
// releases it immediately before H5Fcreate, whose first superblock
// write reallocs the core buffer to the full increment and takes the
// warm chunk back.
void* g_core_holder = nullptr;

}  // namespace

extern "C" int sio_h5_mem_available() {
    return g_h5.ready && g_h5.mem_ready ? 1 : 0;
}

extern "C" void sio_h5_mem_prewarm() {
    // Fault the mem path's big blocks ONCE, at a moment the caller knows
    // is idle (the writer child boots while the parent compiles/streams
    // kinematics). First touches cost a fluctuating 2-35 us/page on this
    // VM (~30-60 s for the ~3 GB below at the bad end); afterwards the
    // steady-state per-file loop runs with ZERO fresh faults. Order
    // matters: size the arena first so the increment-sized chunk freed
    // last is the exact warm block glibc hands the next core-VFD open.
    auto& buf = arena();
    if (buf.size() < kCoreIncrement) buf.resize(kCoreIncrement);
    std::memset(buf.data(), 1, buf.size());
    void* p = std::malloc(kCoreIncrement);
    if (p) {
        std::memset(p, 1, kCoreIncrement);
        std::free(p);
    }
}

extern "C" void* sio_h5_open_mem() {
    if (!g_h5.ready || !g_h5.mem_ready) return nullptr;
    hid fapl = g_h5.pcreate(g_h5.cls_facc);
    if (fapl < 0) return nullptr;
    // backing_store = false: sio_h5_close_mem materializes the image.
    if (g_h5.set_fapl_core(fapl, kCoreIncrement, 0) < 0) {
        g_h5.pclose(fapl);
        return nullptr;
    }
    if (g_use_latest && g_h5.set_libver)
        g_h5.set_libver(fapl, 1, 1);  // best-effort, see sio_h5_set_latest
    static int seq = 0;
    char name[32];
    std::snprintf(name, sizeof(name), "siomem-%d.h5", seq++);
    if (g_core_holder) {  // hand the warm chunk to H5Fcreate's realloc
        std::free(g_core_holder);
        g_core_holder = nullptr;
    }
    hid f = g_h5.fcreate(name, H5F_ACC_TRUNC_, H5P_DEFAULT_, fapl);
    g_h5.pclose(fapl);
    if (f < 0) return nullptr;
    hid g = g_h5.gcreate2(f, "cloud", H5P_DEFAULT_, H5P_DEFAULT_,
                          H5P_DEFAULT_);
    if (g < 0) {
        g_h5.fclose(f);
        return nullptr;
    }
    return new Writer{f, g};
}

extern "C" int sio_h5_close_mem(void* handle, int64_t min_event,
                                int64_t max_event, const char* path) {
    auto* w = static_cast<Writer*>(handle);
    if (!w || !g_h5.mem_ready) return -1;
    int rc = 0;
    rc |= attr_i64(w->group, "min_event", min_event);
    rc |= attr_i64(w->group, "max_event", max_event);
    g_h5.gclose(w->group);
    if (rc == 0 && g_h5.fflush(w->file, 1 /* H5F_SCOPE_GLOBAL */) < 0)
        rc = -3;
    const int64_t img = rc == 0 ? g_h5.get_file_image(w->file, nullptr, 0)
                                : -1;
    if (rc == 0 && img <= 0) rc = -4;
    int64_t eof_size = -1;
    if (rc == 0) {
        auto& buf = arena();
        if (static_cast<int64_t>(buf.size()) < img)
            buf.resize(static_cast<size_t>(img));
        if (g_h5.get_file_image(w->file, buf.data(),
                                static_cast<size_t>(img)) != img) {
            rc = -5;
        } else {
            // The size a reader will demand is the superblock's stored
            // EOF, which exceeds the image (= EOA) by the file's free
            // space (measured ~100 KB/file on the core VFD). The v0
            // superblock stores it as a little-endian u64 at byte 40
            // (sig[8] + 16 version/size bytes + leaf/internal k[4] +
            // flags[4] + base addr[8]); bytes past EOA are never read,
            // so the sparse ftruncate below satisfies the check for free.
            static const char sig[8] = {'\x89', 'H',    'D', 'F',
                                        '\r',   '\n', '\x1a', '\n'};
            if (std::memcmp(buf.data(), sig, 8) != 0 ||
                buf[8] != 0 /* superblock v0 */ ||
                buf[13] != 8 /* 8-byte offsets */) {
                rc = -11;
            } else {
                uint64_t eof;
                std::memcpy(&eof, buf.data() + 40, 8);
                eof_size = static_cast<int64_t>(eof);
                if (eof_size < img) rc = -12;
            }
        }
    }
    if (rc == 0) {
        // Single pwrite from the warm arena. NO O_TRUNC: a recycled
        // destination's pages are overwritten in place and stay warm —
        // truncation would free them back to the hypervisor and every
        // byte would pay the first-touch fault again (BASELINE.md
        // "page-fault tax").
        int fd = ::open(path, O_RDWR | O_CREAT, 0644);
        if (fd < 0) {
            // a bad recycled predecessor (wrong perms/type) must not lose
            // the batch: drop it and create fresh (paying the fault tax
            // once for this file only)
            std::fprintf(stderr, "[spyral_io] open(%s) failed (%s); "
                         "retrying with a fresh file\n",
                         path, std::strerror(errno));
            ::unlink(path);
            fd = ::open(path, O_RDWR | O_CREAT, 0644);
        }
        if (fd < 0) {
            std::fprintf(stderr, "[spyral_io] open(%s) failed: %s\n", path,
                         std::strerror(errno));
            rc = -6;
        } else {
            const char* data = arena().data();
            int64_t off = 0;
            while (off < img) {
                ssize_t n = ::pwrite(fd, data + off,
                                     static_cast<size_t>(img - off),
                                     static_cast<off_t>(off));
                if (n < 0 && errno == EINTR) continue;
                if (n <= 0) {
                    std::fprintf(stderr,
                                 "[spyral_io] pwrite(%s) failed: %s\n",
                                 path, std::strerror(errno));
                    rc = -7;
                    break;
                }
                off += n;
            }
            // grow sparsely to the stored EOF / shrink a recycled file's
            // surplus tail to it
            if (rc == 0 &&
                ::ftruncate(fd, static_cast<off_t>(eof_size)) != 0)
                rc = -8;
            if (::close(fd) != 0 && rc == 0) rc = -9;
        }
    }
    if (g_h5.fclose(w->file) < 0 && rc == 0) rc = -10;
    // H5Fclose just freed the ~increment-sized core buffer; capture the
    // chunk before any other allocation can split it (see g_core_holder)
    if (!g_core_holder) g_core_holder = std::malloc(kCoreIncrement);
    delete w;
    return rc;
}

extern "C" int sio_have() { return 1; }
