// Asynchronous snapshot writer.
//
// Native replacement for the reference's collective MPI-IO output path
// (reference src/polargrid.cpp:135-186 write2D / src/output.cpp:249-304
// write_full_output): field buffers are copied into a queue and written to
// disk by a background worker thread, so the simulation loop (and the TPU
// pipeline feeding it) never stalls on disk I/O. Exposed through a plain C
// ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -pthread async_writer.cpp -o libasyncwriter.so

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;
    std::vector<uint8_t> data;
};

class AsyncWriter {
  public:
    AsyncWriter() : stop_(false), errors_(0), bytes_written_(0) {
        worker_ = std::thread([this] { run(); });
    }

    ~AsyncWriter() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
        }
        cv_.notify_all();
        worker_.join();
    }

    void submit(const char *path, const void *data, size_t nbytes) {
        Job job;
        job.path = path;
        job.data.resize(nbytes);
        std::memcpy(job.data.data(), data, nbytes);
        {
            std::unique_lock<std::mutex> lk(mu_);
            queue_.push_back(std::move(job));
        }
        cv_.notify_all();
    }

    // Block until every queued job has hit the filesystem.
    void flush() {
        std::unique_lock<std::mutex> lk(mu_);
        done_cv_.wait(lk, [this] { return queue_.empty() && !busy_; });
    }

    long errors() const { return errors_; }
    long long bytes_written() const { return bytes_written_; }
    size_t pending() {
        std::unique_lock<std::mutex> lk(mu_);
        return queue_.size() + (busy_ ? 1 : 0);
    }

  private:
    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
                if (queue_.empty()) {
                    if (stop_) return;
                    continue;
                }
                job = std::move(queue_.front());
                queue_.pop_front();
                busy_ = true;
            }
            write_job(job);
            {
                std::unique_lock<std::mutex> lk(mu_);
                busy_ = false;
            }
            done_cv_.notify_all();
        }
    }

    void write_job(const Job &job) {
        FILE *f = std::fopen(job.path.c_str(), "wb");
        if (!f) {
            ++errors_;
            return;
        }
        size_t n = std::fwrite(job.data.data(), 1, job.data.size(), f);
        if (n != job.data.size()) ++errors_;
        std::fclose(f);
        bytes_written_ += static_cast<long long>(n);
    }

    std::thread worker_;
    std::mutex mu_;
    std::condition_variable cv_;
    std::condition_variable done_cv_;
    std::deque<Job> queue_;
    bool stop_;
    bool busy_ = false;
    long errors_;
    long long bytes_written_;
};

}  // namespace

extern "C" {

void *awriter_create() { return new AsyncWriter(); }

void awriter_submit(void *handle, const char *path, const void *data,
                    size_t nbytes) {
    static_cast<AsyncWriter *>(handle)->submit(path, data, nbytes);
}

void awriter_flush(void *handle) {
    static_cast<AsyncWriter *>(handle)->flush();
}

long awriter_errors(void *handle) {
    return static_cast<AsyncWriter *>(handle)->errors();
}

long long awriter_bytes_written(void *handle) {
    return static_cast<AsyncWriter *>(handle)->bytes_written();
}

size_t awriter_pending(void *handle) {
    return static_cast<AsyncWriter *>(handle)->pending();
}

void awriter_destroy(void *handle) {
    delete static_cast<AsyncWriter *>(handle);
}

}  // extern "C"
