// mlt_data: native token-shard data loader (libmlt_data.so) of
// mlrun_tpu_torch — the port's own copy of the JAX package's loader source
// (native/data_loader.cpp), built at first use by ops/_build.build_host.
//
// Training shards are flat little-endian token files (int32 or uint16)
// memory-mapped read-only; worker threads cut shuffled fixed-length
// windows and stage ready batches in a bounded ring buffer so the host
// never stalls the GPU step on tokenization/IO.
//
// C ABI (driven from Python via ctypes — no pybind11 in this image):
//   mlt_loader_open(paths, n_paths, dtype_code, batch, seq, seed, workers,
//                   queue_depth) -> handle (0 on error)
//   mlt_loader_next(handle, out_tokens /* int32[batch*(seq+1)] */)
//       -> 1 ok, 0 closed/error   (blocks until a batch is staged)
//   mlt_loader_total_tokens(handle) -> u64
//   mlt_loader_epoch(handle) -> u64 (completed shuffle epochs)
//   mlt_loader_stats(handle, out_u64 /* [5]: ring occupancy, queue depth,
//                    batches served, consumer waits, producer waits */)
//       -> 1 ok, 0 bad handle
//   mlt_loader_close(handle)
//
// Shuffling: each epoch draws a new permutation of window starts
// (seeded, deterministic); windows never cross shard boundaries.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
    const uint8_t* data = nullptr;
    size_t bytes = 0;
    size_t tokens = 0;
    int fd = -1;
};

struct Window {
    uint32_t shard;
    uint64_t start;  // token offset within the shard
};

struct Loader {
    std::vector<Shard> shards;
    int dtype_code;   // 4 = int32, 2 = uint16
    uint64_t batch, seq;
    uint64_t seed;
    std::vector<Window> windows;

    std::deque<std::vector<int32_t>> ready;
    size_t queue_depth;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::atomic<bool> closing{false};
    std::atomic<uint64_t> epoch{0};
    std::atomic<int> inflight{0};  // mlt_loader_next calls in progress
    // occupancy/wait telemetry (mlt_loader_stats): consumer_waits counts
    // next() calls that found the ring empty (the step loop stalled on
    // IO), producer_waits counts workers that found it full (IO is ahead)
    std::atomic<uint64_t> batches_served{0};
    std::atomic<uint64_t> consumer_waits{0};
    std::atomic<uint64_t> producer_waits{0};
    std::vector<std::thread> threads;

    // work list for the current epoch (indices into `windows`)
    std::vector<uint32_t> order;
    size_t next_window = 0;
    std::mt19937_64 rng;

    ~Loader() {
        for (auto& shard : shards) {
            if (shard.data) munmap(const_cast<uint8_t*>(shard.data),
                                   shard.bytes);
            if (shard.fd >= 0) close(shard.fd);
        }
    }
};

std::mutex g_mu;
std::map<uint64_t, Loader*> g_loaders;
uint64_t g_next_handle = 1;

int32_t token_at(const Loader& ld, const Shard& shard, uint64_t idx) {
    if (ld.dtype_code == 4) {
        int32_t v;
        std::memcpy(&v, shard.data + idx * 4, 4);
        return v;
    }
    uint16_t v;
    std::memcpy(&v, shard.data + idx * 2, 2);
    return static_cast<int32_t>(v);
}

// pop the next window index, reshuffling when the epoch is exhausted.
// caller holds ld.mu.
bool next_window_locked(Loader& ld, Window* out) {
    if (ld.order.empty()) return false;
    if (ld.next_window >= ld.order.size()) {
        std::shuffle(ld.order.begin(), ld.order.end(), ld.rng);
        ld.next_window = 0;
        ld.epoch.fetch_add(1);
    }
    *out = ld.windows[ld.order[ld.next_window++]];
    return true;
}

void worker(Loader* ld) {
    const uint64_t row = ld->seq + 1;
    while (!ld->closing.load()) {
        // reserve the batch's windows under the lock; copy token data
        // OUTSIDE it so workers overlap on the actual IO/memcpy work
        std::vector<Window> wins(ld->batch);
        {
            std::unique_lock<std::mutex> lock(ld->mu);
            for (uint64_t b = 0; b < ld->batch; ++b)
                if (!next_window_locked(*ld, &wins[b])) return;
        }
        std::vector<int32_t> batch(ld->batch * row);
        for (uint64_t b = 0; b < ld->batch; ++b) {
            const Shard& shard = ld->shards[wins[b].shard];
            if (ld->dtype_code == 4) {
                std::memcpy(batch.data() + b * row,
                            shard.data + wins[b].start * 4, row * 4);
            } else {
                for (uint64_t t = 0; t < row; ++t)
                    batch[b * row + t] =
                        token_at(*ld, shard, wins[b].start + t);
            }
        }
        std::unique_lock<std::mutex> lock(ld->mu);
        if (!ld->closing.load() && ld->ready.size() >= ld->queue_depth)
            ld->producer_waits.fetch_add(1);
        ld->cv_space.wait(lock, [&] {
            return ld->closing.load() || ld->ready.size() < ld->queue_depth;
        });
        if (ld->closing.load()) return;
        ld->ready.push_back(std::move(batch));
        ld->cv_ready.notify_one();
    }
}

}  // namespace

extern "C" {

uint64_t mlt_loader_open(const char** paths, uint32_t n_paths,
                         int dtype_code, uint64_t batch, uint64_t seq,
                         uint64_t seed, uint32_t workers,
                         uint32_t queue_depth) {
    if (!paths || n_paths == 0 || (dtype_code != 4 && dtype_code != 2) ||
        batch == 0 || seq == 0)
        return 0;
    auto ld = new Loader();
    ld->dtype_code = dtype_code;
    ld->batch = batch;
    ld->seq = seq;
    ld->seed = seed;
    ld->queue_depth = queue_depth ? queue_depth : 4;
    ld->rng.seed(seed);

    const uint64_t row = seq + 1;
    for (uint32_t i = 0; i < n_paths; ++i) {
        Shard shard;
        shard.fd = open(paths[i], O_RDONLY);
        if (shard.fd < 0) { delete ld; return 0; }
        struct stat st;
        if (fstat(shard.fd, &st) != 0 || st.st_size <= 0) {
            delete ld; return 0;
        }
        shard.bytes = static_cast<size_t>(st.st_size);
        shard.tokens = shard.bytes / static_cast<size_t>(dtype_code);
        shard.data = static_cast<const uint8_t*>(
            mmap(nullptr, shard.bytes, PROT_READ, MAP_PRIVATE, shard.fd, 0));
        if (shard.data == MAP_FAILED) { shard.data = nullptr; delete ld;
                                        return 0; }
        madvise(const_cast<uint8_t*>(shard.data), shard.bytes,
                MADV_SEQUENTIAL);
        uint32_t shard_idx = static_cast<uint32_t>(ld->shards.size());
        // non-overlapping windows of seq+1 tokens, fully inside the shard
        for (uint64_t start = 0; start + row <= shard.tokens; start += row)
            ld->windows.push_back(Window{shard_idx, start});
        ld->shards.push_back(shard);
    }
    if (ld->windows.empty()) { delete ld; return 0; }
    ld->order.resize(ld->windows.size());
    std::iota(ld->order.begin(), ld->order.end(), 0);
    std::shuffle(ld->order.begin(), ld->order.end(), ld->rng);

    if (workers == 0) workers = 2;
    for (uint32_t i = 0; i < workers; ++i)
        ld->threads.emplace_back(worker, ld);

    std::lock_guard<std::mutex> lock(g_mu);
    uint64_t handle = g_next_handle++;
    g_loaders[handle] = ld;
    return handle;
}

int mlt_loader_next(uint64_t handle, int32_t* out_tokens) {
    Loader* ld;
    {
        // the inflight count is taken under g_mu so close() (which erases
        // the handle under the same lock before draining) can never free
        // the Loader while a next() is inside it
        std::lock_guard<std::mutex> lock(g_mu);
        auto it = g_loaders.find(handle);
        if (it == g_loaders.end()) return 0;
        ld = it->second;
        ld->inflight.fetch_add(1);
    }
    int result = 0;
    {
        std::unique_lock<std::mutex> lock(ld->mu);
        if (ld->ready.empty() && !ld->closing.load())
            ld->consumer_waits.fetch_add(1);
        ld->cv_ready.wait(lock, [&] {
            return ld->closing.load() || !ld->ready.empty();
        });
        if (!ld->ready.empty()) {
            std::vector<int32_t> batch = std::move(ld->ready.front());
            ld->ready.pop_front();
            ld->batches_served.fetch_add(1);
            ld->cv_space.notify_one();
            lock.unlock();
            std::memcpy(out_tokens, batch.data(),
                        batch.size() * sizeof(int32_t));
            result = 1;
        }
    }
    ld->inflight.fetch_sub(1);
    return result;
}

uint64_t mlt_loader_total_tokens(uint64_t handle) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return 0;
    uint64_t total = 0;
    for (const auto& shard : it->second->shards) total += shard.tokens;
    return total;
}

uint64_t mlt_loader_epoch(uint64_t handle) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return 0;
    return it->second->epoch.load();
}

int mlt_loader_stats(uint64_t handle, uint64_t* out) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end() || !out) return 0;
    Loader* ld = it->second;
    {
        std::lock_guard<std::mutex> ring(ld->mu);
        out[0] = ld->ready.size();
    }
    out[1] = ld->queue_depth;
    out[2] = ld->batches_served.load();
    out[3] = ld->consumer_waits.load();
    out[4] = ld->producer_waits.load();
    return 1;
}

void mlt_loader_close(uint64_t handle) {
    Loader* ld;
    {
        std::lock_guard<std::mutex> lock(g_mu);
        auto it = g_loaders.find(handle);
        if (it == g_loaders.end()) return;
        ld = it->second;
        g_loaders.erase(it);
    }
    ld->closing.store(true);
    ld->cv_ready.notify_all();
    ld->cv_space.notify_all();
    for (auto& thread : ld->threads) thread.join();
    // drain concurrent next() callers (handle already erased, so no new
    // ones can enter) before freeing
    while (ld->inflight.load() > 0) {
        ld->cv_ready.notify_all();
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    delete ld;
}

}  // extern "C"
