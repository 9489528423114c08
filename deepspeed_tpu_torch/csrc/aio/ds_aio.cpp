// Async file I/O engine for ZeRO-Infinity NVMe offload.
//
// TPU-native counterpart of the reference's libaio/io_uring engines
// (csrc/aio/common/deepspeed_aio_common.cpp, py_lib/deepspeed_py_io_handle.cpp):
// services pread/pwrite requests asynchronously so the training loop
// overlaps NVMe traffic with compute. Exposed as a plain C API consumed
// via ctypes (no pybind11 in this image).
//
// Two backends, chosen at engine creation:
//  - io_uring (kernel >= 5.1): one ring, true async submission at
//    queue_depth without per-request threads. Probed at runtime —
//    container seccomp policies commonly deny the syscalls, in which
//    case we silently fall back to...
//  - a pinned-buffer-friendly pread/pwrite THREAD POOL.
//
// Both backends STRIPE large requests (r5, VERDICT #10): a single
// multi-hundred-MB group fetch previously ran as one worker's
// sequential pread loop — queue depth 1 no matter how many workers.
// Requests are split into `stripe_bytes` sub-ops sharing one completion
// count, so one big read keeps the whole queue busy.
//
// Build: op_builder/async_io.py JIT-compiles this file with g++ -O3 -shared.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <functional>
#include <linux/io_uring.h>
#include <memory>
#include <mutex>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kDefaultStripe = 8 << 20;  // 8 MB sub-ops

struct Request {
    bool write;
    int fd;
    void* buf;
    int64_t nbytes;
    int64_t offset;
};

// ---------------------------------------------------------------- io_uring
// Minimal raw-syscall io_uring wrapper (no liburing in this image).

int sys_io_uring_setup(unsigned entries, struct io_uring_params* p) {
    return (int)syscall(__NR_io_uring_setup, entries, p);
}

int sys_io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                       unsigned flags) {
    return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                        flags, nullptr, 0);
}

class UringBackend {
  public:
    static UringBackend* Create(int queue_depth) {
        io_uring_params p;
        memset(&p, 0, sizeof(p));
        int fd = sys_io_uring_setup(queue_depth, &p);
        if (fd < 0) return nullptr;  // denied (seccomp) or unsupported
        auto* u = new UringBackend();
        u->ring_fd_ = fd;
        u->depth_ = p.sq_entries;
        u->sq_sz_ = p.sq_off.array + p.sq_entries * sizeof(unsigned);
        u->cq_sz_ = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        u->sqes_sz_ = p.sq_entries * sizeof(io_uring_sqe);
        u->sq_mem_ = mmap(nullptr, u->sq_sz_, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
        u->cq_mem_ = mmap(nullptr, u->cq_sz_, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
        u->sqes_ = (io_uring_sqe*)mmap(
            nullptr, u->sqes_sz_,
            PROT_READ | PROT_WRITE, MAP_SHARED | MAP_POPULATE, fd,
            IORING_OFF_SQES);
        if (u->sq_mem_ == MAP_FAILED || u->cq_mem_ == MAP_FAILED ||
            u->sqes_ == MAP_FAILED) {
            delete u;
            return nullptr;
        }
        char* sq = (char*)u->sq_mem_;
        u->sq_head_ = (std::atomic<unsigned>*)(sq + p.sq_off.head);
        u->sq_tail_ = (std::atomic<unsigned>*)(sq + p.sq_off.tail);
        u->sq_mask_ = *(unsigned*)(sq + p.sq_off.ring_mask);
        u->sq_array_ = (unsigned*)(sq + p.sq_off.array);
        char* cq = (char*)u->cq_mem_;
        u->cq_head_ = (std::atomic<unsigned>*)(cq + p.cq_off.head);
        u->cq_tail_ = (std::atomic<unsigned>*)(cq + p.cq_off.tail);
        u->cq_mask_ = *(unsigned*)(cq + p.cq_off.ring_mask);
        u->cqes_ = (io_uring_cqe*)(cq + p.cq_off.cqes);
        // Probe an ACTUAL read op: io_uring_setup succeeding only proves
        // kernel >= 5.1, but IORING_OP_READ needs >= 5.6 — on 5.1-5.5
        // every op would fail -EINVAL with no fallback. One 1-byte read
        // of /dev/zero settles it.
        if (!u->probe_read()) {
            delete u;
            return nullptr;
        }
        return u;
    }

    // Unmap the sq/cq/sqe ring mappings as well as closing the ring fd —
    // runs on Create() failure paths too (partial maps are MAP_FAILED and
    // skipped). Without the munmaps every engine create/destroy cycle
    // leaked the three ring mappings.
    ~UringBackend() {
        if (sqes_ != (io_uring_sqe*)MAP_FAILED && sqes_ != nullptr)
            munmap(sqes_, sqes_sz_);
        if (cq_mem_ != MAP_FAILED) munmap(cq_mem_, cq_sz_);
        if (sq_mem_ != MAP_FAILED) munmap(sq_mem_, sq_sz_);
        if (ring_fd_ >= 0) close(ring_fd_);
    }

    bool probe_read() {
        int zfd = open("/dev/zero", O_RDONLY);
        if (zfd < 0) return false;
        char byte = 0;
        std::vector<Request> one{Request{false, zfd, &byte, 1, 0}};
        bool ok = run(one) == 0;
        close(zfd);
        return ok;
    }

    // Finish one request synchronously via the pread/pwrite fallback —
    // the escape hatch for sub-ops the ring refused or completed short.
    // Returns 1 on failure, 0 on success.
    static int64_t sync_op(const Request& r) {
        int64_t done = 0;
        char* p = (char*)r.buf;
        while (done < r.nbytes) {
            ssize_t n = r.write
                ? pwrite(r.fd, p + done, r.nbytes - done, r.offset + done)
                : pread(r.fd, p + done, r.nbytes - done, r.offset + done);
            if (n <= 0) return 1;
            done += n;
        }
        return 0;
    }

    // Push as many of ops[next..) as fit in the ring and kick the kernel
    // WITHOUT waiting (min_complete=0) — I/O starts at submit time, so
    // disk work overlaps whatever the caller does before wait_all().
    // A non-EINTR enter failure (or partial submission) would otherwise
    // leave queued-but-unsubmitted SQEs counted as in-flight, and
    // wait_all() would hang forever on completions that can never
    // arrive: those sub-ops are rolled back off the SQ tail and finished
    // synchronously via the pread/pwrite fallback instead.
    void start(std::vector<Request>& ops, size_t& next, size_t& inflight) {
        unsigned queued = 0;
        unsigned tail0 = sq_tail_->load(std::memory_order_relaxed);
        while (next < ops.size() && inflight < depth_) {
            unsigned tail = sq_tail_->load(std::memory_order_relaxed);
            unsigned idx = tail & sq_mask_;
            io_uring_sqe* sqe = &sqes_[idx];
            memset(sqe, 0, sizeof(*sqe));
            Request& r = ops[next];
            sqe->opcode = r.write ? IORING_OP_WRITE : IORING_OP_READ;
            sqe->fd = r.fd;
            sqe->addr = (uint64_t)r.buf;
            sqe->len = (unsigned)r.nbytes;
            sqe->off = (uint64_t)r.offset;
            sqe->user_data = next;
            sq_array_[idx] = idx;
            sq_tail_->store(tail + 1, std::memory_order_release);
            ++next;
            ++inflight;
            ++queued;
        }
        if (!queued) return;
        int ret;
        do {
            ret = sys_io_uring_enter(ring_fd_, queued, 0, 0);
        } while (ret < 0 && errno == EINTR);
        unsigned submitted =
            ret < 0 ? 0 : std::min((unsigned)ret, queued);
        if (submitted == queued) return;
        unsigned unsub = queued - submitted;
        sq_tail_->store(tail0 + submitted, std::memory_order_release);
        for (size_t i = next - unsub; i < next; ++i) {
            sync_errors_ += sync_op(ops[i]);
            --inflight;  // completed synchronously, never in the kernel
        }
    }

    // Drain every CQE the kernel has posted, inspecting cqe->res per op:
    // success, short op (finished synchronously), or a real error.
    void reap(std::vector<Request>& ops, size_t& completed, size_t& inflight,
              int64_t& errors) {
        unsigned head = cq_head_->load(std::memory_order_acquire);
        unsigned tail = cq_tail_->load(std::memory_order_acquire);
        while (head != tail) {
            io_uring_cqe* cqe = &cqes_[head & cq_mask_];
            Request& r = ops[cqe->user_data];
            if (cqe->res < 0) {
                ++errors;
            } else if ((int64_t)cqe->res < r.nbytes) {
                // short op: finish the tail synchronously (rare)
                Request rest{r.write, r.fd, (char*)r.buf + cqe->res,
                             r.nbytes - cqe->res, r.offset + cqe->res};
                errors += sync_op(rest);
            }
            ++head;
            ++completed;
            --inflight;
        }
        cq_head_->store(head, std::memory_order_release);
    }

    // Drive `ops` to completion; returns failed-op count. Short ops are
    // finished synchronously. EINTR retries; the ring is ALWAYS drained
    // (with a bounded grace period on ring failure) before returning, so
    // no in-flight DMA can outlive the call.
    int64_t run(std::vector<Request>& ops, size_t next = 0,
                size_t inflight = 0) {
        int64_t errors = 0;
        size_t completed = next - inflight;
        while (completed < ops.size()) {
            start(ops, next, inflight);
            // start() may have finished sub-ops synchronously on an enter
            // failure — recompute before blocking on a completion
            completed = next - inflight;
            if (completed >= ops.size()) break;
            int ret;
            do {
                ret = sys_io_uring_enter(ring_fd_, 0, 1,
                                         IORING_ENTER_GETEVENTS);
            } while (ret < 0 && errno == EINTR);
            if (ret < 0) {
                // Unexpected ring failure: BOUNDED drain, not a bare
                // busy-spin. Already-submitted I/O still completes via the
                // kernel's async workers, so poll the CQ ring (inspecting
                // each cqe->res — a drained CQE is usually a success, not
                // an error) with a sleep between attempts; after the
                // budget, in-flight ops that never posted count as errors
                // and the never-started remainder falls back to
                // synchronous pread/pwrite.
                for (int attempt = 0; inflight > 0 && attempt < 100;
                     ++attempt) {
                    reap(ops, completed, inflight, errors);
                    if (inflight == 0) break;
                    usleep(1000);
                }
                if (inflight > 0) {
                    errors += (int64_t)inflight;
                    completed += inflight;
                    inflight = 0;
                }
                while (next < ops.size()) {
                    errors += sync_op(ops[next]);
                    ++next;
                    ++completed;
                }
                break;
            }
            reap(ops, completed, inflight, errors);
        }
        errors += sync_errors_;
        sync_errors_ = 0;
        return errors;
    }

  private:
    int ring_fd_ = -1;
    unsigned depth_ = 0;
    void* sq_mem_ = MAP_FAILED;
    void* cq_mem_ = MAP_FAILED;
    io_uring_sqe* sqes_ = (io_uring_sqe*)MAP_FAILED;
    size_t sq_sz_ = 0, cq_sz_ = 0, sqes_sz_ = 0;
    std::atomic<unsigned>*sq_head_, *sq_tail_, *cq_head_, *cq_tail_;
    unsigned sq_mask_, cq_mask_;
    unsigned* sq_array_;
    io_uring_cqe* cqes_ = nullptr;
    // failures of sub-ops start() completed synchronously (enter refused
    // them); folded into the next run()'s error count
    int64_t sync_errors_ = 0;
};

// ------------------------------------------------------------- thread pool

class AioEngine {
  public:
    AioEngine(int num_threads, int queue_depth, int64_t stripe_bytes)
        : stripe_(stripe_bytes > 0 ? stripe_bytes : kDefaultStripe),
          stop_(false) {
        uring_.reset(UringBackend::Create(queue_depth > 0 ? queue_depth : 32));
        if (uring_) return;  // io_uring path needs no workers
        for (int i = 0; i < num_threads; ++i) {
            workers_.emplace_back([this] { this->worker(); });
        }
    }

    ~AioEngine() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }

    bool using_uring() const { return uring_ != nullptr; }

    void submit(bool write, int fd, void* buf, int64_t nbytes,
                int64_t offset) {
        // stripe: one logical request becomes nbytes/stripe_ sub-ops so a
        // single big group fetch fills the whole queue
        char* p = static_cast<char*>(buf);
        std::unique_lock<std::mutex> lk(mu_);
        for (int64_t off = 0; off < nbytes; off += stripe_) {
            int64_t n = std::min(stripe_, nbytes - off);
            Request r{write, fd, p + off, n, offset + off};
            if (uring_) {
                ops_.push_back(r);
            } else {
                queue_.push_back(r);
                inflight_++;
            }
        }
        if (uring_) {
            // kick the ring NOW (min_complete=0): the I/O runs while the
            // caller keeps working, preserving the swapper's overlap
            // semantics (queue group i+1's reads ‖ group i's H2D)
            uring_->start(ops_, unext_, uinflight_);
        } else {
            cv_.notify_all();
        }
    }

    int64_t wait_all() {
        if (uring_) {
            std::unique_lock<std::mutex> lk(mu_);
            int64_t e = ops_.empty()
                ? 0 : uring_->run(ops_, unext_, uinflight_);
            ops_.clear();
            unext_ = 0;
            uinflight_ = 0;
            return e;
        }
        std::unique_lock<std::mutex> lk(done_mu_);
        done_cv_.wait(lk, [this] { return inflight_.load() == 0; });
        return errors_.exchange(0);
    }

  private:
    void worker() {
        for (;;) {
            Request req;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (stop_ && queue_.empty()) return;
                req = queue_.front();
                queue_.pop_front();
            }
            int64_t done = 0;
            char* p = static_cast<char*>(req.buf);
            while (done < req.nbytes) {
                ssize_t n = req.write
                    ? pwrite(req.fd, p + done, req.nbytes - done, req.offset + done)
                    : pread(req.fd, p + done, req.nbytes - done, req.offset + done);
                if (n <= 0) {
                    errors_++;
                    break;
                }
                done += n;
            }
            if (--inflight_ == 0) {
                std::unique_lock<std::mutex> lk(done_mu_);
                done_cv_.notify_all();
            }
        }
    }

    const int64_t stripe_;
    std::unique_ptr<UringBackend> uring_;
    std::vector<Request> ops_;   // uring: striped ops of the current batch
    size_t unext_ = 0;           // uring: ops submitted so far
    size_t uinflight_ = 0;       // uring: ops in the kernel right now
    std::vector<std::thread> workers_;
    std::deque<Request> queue_;
    std::mutex mu_, done_mu_;
    std::condition_variable cv_, done_cv_;
    std::atomic<bool> stop_;
    std::atomic<int64_t> inflight_{0};
    std::atomic<int64_t> errors_{0};
};

}  // namespace

extern "C" {

void* ds_aio_create(int num_threads, int queue_depth) {
    return new AioEngine(num_threads, queue_depth, kDefaultStripe);
}

void* ds_aio_create_ex(int num_threads, int queue_depth,
                       long long stripe_bytes) {
    return new AioEngine(num_threads, queue_depth, stripe_bytes);
}

int ds_aio_using_uring(void* h) {
    return static_cast<AioEngine*>(h)->using_uring() ? 1 : 0;
}

void ds_aio_destroy(void* h) { delete static_cast<AioEngine*>(h); }

int ds_aio_open(const char* path, int for_write) {
    if (for_write) return open(path, O_WRONLY | O_CREAT, 0644);
    return open(path, O_RDONLY);
}

void ds_aio_close(int fd) { close(fd); }

long long ds_aio_pread(void* h, int fd, void* buf, long long nbytes,
                       long long offset) {
    static_cast<AioEngine*>(h)->submit(false, fd, buf, nbytes, offset);
    return 0;
}

long long ds_aio_pwrite(void* h, int fd, const void* buf, long long nbytes,
                        long long offset) {
    static_cast<AioEngine*>(h)->submit(true, fd, const_cast<void*>(buf),
                                       nbytes, offset);
    return 0;
}

long long ds_aio_wait(void* h) {
    return static_cast<AioEngine*>(h)->wait_all();
}

}  // extern "C"
