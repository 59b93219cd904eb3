// TPU-host native runtime ops: async file I/O engine + host optimizer kernels.
//
// Capability parity (re-designed, not ported) with the reference's native tier:
//   - csrc/aio/{common,py_lib}: libaio-based O_DIRECT NVMe tensor I/O with a
//     worker-thread pool ("deepspeed_aio_thread.cpp"), block_size/queue_depth
//     tuning knobs, and an `aio_handle` submit/wait API.
//   - csrc/adam/cpu_adam_impl.cpp, csrc/adagrad/cpu_adagrad.cpp,
//     csrc/lion/cpu_lion_impl.cpp: AVX-vectorized host optimizer steps used by
//     ZeRO-Offload when fp32 master states live in host DRAM.
//
// Design here: a portable C++17 thread pool where every submitted request is
// split into `block_size` chunks executed with pread/pwrite (O_DIRECT when the
// alignment contract holds), so one large tensor read/write saturates the
// host's NVMe queue the way the reference's io_submit queue_depth does. The
// optimizer kernels rely on OpenMP `parallel for simd` + compiler
// auto-vectorization instead of hand-written AVX intrinsics: same math, same
// memory traffic, ISA-portable.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cerrno>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr size_t kDirectAlign = 4096;  // O_DIRECT buffer/offset/length contract

struct AioRequest {
    void* buf = nullptr;
    size_t nbytes = 0;
    int fd = -1;
    long file_offset = 0;
    bool is_read = false;
    std::atomic<int> err{0};
};

struct Chunk {
    AioRequest* req;
    size_t off;  // offset within the request
    size_t len;
};

class AioHandle {
public:
    AioHandle(long block_size, int queue_depth, int n_threads, bool use_o_direct)
        : block_size_(block_size > 0 ? static_cast<size_t>(block_size) : (1 << 20)),
          queue_depth_(queue_depth > 0 ? queue_depth : 32),
          o_direct_(use_o_direct) {
        int n = n_threads > 0 ? n_threads : 1;
        for (int i = 0; i < n; ++i) {
            workers_.emplace_back([this] { worker_loop(); });
        }
    }

    ~AioHandle() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
        for (auto* r : pending_) finalize(r);
    }

    long block_size() const { return static_cast<long>(block_size_); }
    int queue_depth() const { return queue_depth_; }
    int thread_count() const { return static_cast<int>(workers_.size()); }

    // Submit one request; chunked across the pool. Returns 0 or -errno.
    long submit(void* buf, size_t nbytes, const char* path, long file_offset,
                bool is_read) {
        int flags = is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
        bool direct = o_direct_ && aligned(buf, nbytes, file_offset);
        int fd = -1;
        if (direct) {
            fd = ::open(path, flags | O_DIRECT, 0644);
        }
        if (fd < 0) {
            fd = ::open(path, flags, 0644);
        }
        if (fd < 0) return -static_cast<long>(errno);

        auto* req = new AioRequest();
        req->buf = buf;
        req->nbytes = nbytes;
        req->fd = fd;
        req->file_offset = file_offset;
        req->is_read = is_read;

        // Enqueue every chunk without blocking: submit must return immediately
        // so compute/swap overlap works (reference async_pread/pwrite contract).
        // Concurrency is bounded by the worker pool; queue_depth is a tuning
        // accessor mirrored from the reference's io_submit depth.
        size_t n_chunks = nbytes == 0 ? 1 : (nbytes + block_size_ - 1) / block_size_;
        {
            std::lock_guard<std::mutex> lk(mu_);
            pending_.push_back(req);
            inflight_chunks_ += n_chunks;
            for (size_t i = 0; i < n_chunks; ++i) {
                size_t off = i * block_size_;
                size_t len = nbytes == 0 ? 0 : std::min(block_size_, nbytes - off);
                queue_.push_back(Chunk{req, off, len});
            }
        }
        cv_.notify_all();
        return 0;
    }

    // Block until every submitted request retires; mirror reference
    // `aio_handle.wait()` semantics: returns the number of completed requests.
    int wait() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return inflight_chunks_ == 0; });
        int completed = 0;
        int first_err = 0;
        for (auto* r : pending_) {
            int e = r->err.load();
            if (e != 0 && first_err == 0) first_err = e;
            finalize(r);
            ++completed;
        }
        pending_.clear();
        return first_err != 0 ? -first_err : completed;
    }

private:
    bool aligned(const void* buf, size_t nbytes, long off) const {
        // Chunks are cut at block_size_ boundaries, so the block size itself
        // must keep every mid-request offset on the O_DIRECT alignment grid.
        return reinterpret_cast<uintptr_t>(buf) % kDirectAlign == 0 &&
               nbytes % kDirectAlign == 0 &&
               static_cast<size_t>(off) % kDirectAlign == 0 &&
               block_size_ % kDirectAlign == 0;
    }

    static void finalize(AioRequest* r) {
        if (r->fd >= 0) ::close(r->fd);
        delete r;
    }

    void worker_loop() {
        for (;;) {
            Chunk c;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                c = queue_.front();
                queue_.pop_front();
            }
            run_chunk(c);
            {
                std::lock_guard<std::mutex> lk(mu_);
                if (--inflight_chunks_ == 0) done_cv_.notify_all();
            }
        }
    }

    void run_chunk(const Chunk& c) {
        AioRequest* r = c.req;
        char* p = static_cast<char*>(r->buf) + c.off;
        size_t remaining = c.len;
        off_t pos = r->file_offset + static_cast<off_t>(c.off);
        while (remaining > 0) {
            ssize_t n = r->is_read ? ::pread(r->fd, p, remaining, pos)
                                   : ::pwrite(r->fd, p, remaining, pos);
            if (n < 0) {
                if (errno == EINTR) continue;
                r->err.store(errno);
                break;
            }
            if (n == 0) {  // short file on read
                r->err.store(EIO);
                break;
            }
            p += n;
            pos += n;
            remaining -= static_cast<size_t>(n);
        }
    }

    size_t block_size_;
    int queue_depth_;
    bool o_direct_;
    std::vector<std::thread> workers_;
    std::deque<Chunk> queue_;
    std::vector<AioRequest*> pending_;
    std::mutex mu_;
    std::condition_variable cv_, done_cv_;
    size_t inflight_chunks_ = 0;
    bool stop_ = false;
};

}  // namespace

extern "C" {

void* ds_aio_create(long block_size, int queue_depth, int n_threads, int o_direct) {
    return new AioHandle(block_size, queue_depth, n_threads, o_direct != 0);
}

void ds_aio_destroy(void* h) { delete static_cast<AioHandle*>(h); }

long ds_aio_block_size(void* h) { return static_cast<AioHandle*>(h)->block_size(); }
int ds_aio_queue_depth(void* h) { return static_cast<AioHandle*>(h)->queue_depth(); }
int ds_aio_thread_count(void* h) { return static_cast<AioHandle*>(h)->thread_count(); }

long ds_aio_submit(void* h, void* buf, long nbytes, const char* path,
                   long file_offset, int is_read) {
    return static_cast<AioHandle*>(h)->submit(buf, static_cast<size_t>(nbytes), path,
                                              file_offset, is_read != 0);
}

int ds_aio_wait(void* h) { return static_cast<AioHandle*>(h)->wait(); }

// Aligned host buffers — the analog of the reference's pinned-tensor pool
// (csrc/aio/py_lib/deepspeed_pin_tensor.cpp): page-aligned so O_DIRECT engages
// and host<->device DMA stays copy-free.
void* ds_alloc_aligned(long nbytes) {
    void* p = nullptr;
    size_t n = (static_cast<size_t>(nbytes) + kDirectAlign - 1) & ~(kDirectAlign - 1);
    if (posix_memalign(&p, kDirectAlign, n == 0 ? kDirectAlign : n) != 0) return nullptr;
    return p;
}

void ds_free_aligned(void* p) { free(p); }

// ----------------------------------------------------------------------------
// Host optimizer kernels (ZeRO-Offload step path).
// fp32 master params/states in host DRAM; bias corrections precomputed by the
// caller so the inner loop is a pure fused elementwise chain.
// ----------------------------------------------------------------------------

void ds_adam_step(long n, float* p, const float* g, float* m, float* v,
                  float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adamw, float bc1, float bc2) {
    const float omb1 = 1.0f - beta1, omb2 = 1.0f - beta2;
    const float inv_bc1 = 1.0f / bc1;
    const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);
#pragma omp parallel for simd schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        if (!adamw && weight_decay > 0.0f) grad += weight_decay * p[i];
        float mi = beta1 * m[i] + omb1 * grad;
        float vi = beta2 * v[i] + omb2 * grad * grad;
        m[i] = mi;
        v[i] = vi;
        float denom = std::sqrt(vi) * inv_sqrt_bc2 + eps;
        float upd = (mi * inv_bc1) / denom;
        if (adamw && weight_decay > 0.0f) upd += weight_decay * p[i];
        p[i] -= lr * upd;
    }
}

void ds_adagrad_step(long n, float* p, const float* g, float* h,
                     float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        if (weight_decay > 0.0f) grad += weight_decay * p[i];
        float hi = h[i] + grad * grad;
        h[i] = hi;
        p[i] -= lr * grad / (std::sqrt(hi) + eps);
    }
}

void ds_lion_step(long n, float* p, const float* g, float* m,
                  float lr, float beta1, float beta2, float weight_decay) {
#pragma omp parallel for simd schedule(static)
    for (long i = 0; i < n; ++i) {
        float grad = g[i];
        float c = beta1 * m[i] + (1.0f - beta1) * grad;
        float sign = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
        float pi = p[i];
        pi -= lr * (sign + weight_decay * pi);
        p[i] = pi;
        m[i] = beta2 * m[i] + (1.0f - beta2) * grad;
    }
}

// bf16 <-> fp32 conversion for the param copy-back after a host step (the
// reference copies fp32 master -> fp16 device params inside cpu_adam).
void ds_f32_to_bf16(long n, const float* src, uint16_t* dst) {
#pragma omp parallel for simd schedule(static)
    for (long i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, &src[i], sizeof(bits));
        if ((bits & 0x7F800000u) == 0x7F800000u && (bits & 0x007FFFFFu) != 0) {
            // NaN: preserve sign + a quiet payload (rounding would carry the
            // mantissa into the exponent and yield +/-0).
            dst[i] = static_cast<uint16_t>((bits >> 16) | 0x0040u);
            continue;
        }
        // round-to-nearest-even
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = static_cast<uint16_t>((bits + rounding) >> 16);
    }
}

void ds_bf16_to_f32(long n, const uint16_t* src, float* dst) {
#pragma omp parallel for simd schedule(static)
    for (long i = 0; i < n; ++i) {
        uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
        std::memcpy(&dst[i], &bits, sizeof(float));
    }
}

}  // extern "C"
