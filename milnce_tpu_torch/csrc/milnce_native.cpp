// milnce_native: host-side native runtime pieces.
//
// 1) reader pool — a threaded subprocess pipe pump for the video-decode
//    hot path.  The reference decodes ffmpeg output inside Python loader
//    workers (video_loader.py:58-95, one subprocess per sample, bytes
//    round-tripping through the interpreter); here N worker threads
//    popen() the decode commands and fread() rawvideo straight into
//    caller-owned (numpy) buffers — no GIL, no Python copies.
//
// 2) soft-DTW CPU kernels — exact forward/backward DP (the role of the
//    reference's numba nopython kernels, soft_dtw_cuda.py:185-240), used
//    as a fast host-side golden check and eval fallback; threaded over
//    the batch.
//
// Build: milnce_tpu_torch/native/build.py runs
//   g++ -O3 -shared -fPIC -pthread -std=c++17 -o <lib> milnce_native.cpp
// into build/torch_kernels/ at first use.
// Binding: ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------- reader

namespace {

struct Job {
  std::string cmd;
  uint8_t* buf;
  long capacity;
  long bytes_read = -1;
  bool done = false;
};

// Jobs live in an id-keyed map: node-based, so concurrent reader_submit
// calls never invalidate a Job reference a worker holds mid-fread (a
// growable vector would), and reader_wait erases its entry so a
// long-lived pool — one per training run, ~1.2M decodes/epoch — holds
// O(in-flight) jobs, not O(all-ever-submitted).
struct Pool {
  std::vector<std::thread> workers;
  std::deque<long> queue;
  std::unordered_map<long, Job> jobs;
  long next_id = 0;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  bool stopping = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      long id;
      Job* j;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stopping || !queue.empty(); });
        if (stopping && queue.empty()) return;
        id = queue.front();
        queue.pop_front();
        j = &jobs.at(id);  // reference stable: node-based container
      }
      long total = 0;
      FILE* p = popen(j->cmd.c_str(), "r");
      if (p != nullptr) {
        while (total < j->capacity) {
          size_t got = fread(j->buf + total, 1,
                             static_cast<size_t>(j->capacity - total), p);
          if (got == 0) break;
          total += static_cast<long>(got);
        }
        // drain any tail so the child can exit cleanly
        char sink[4096];
        while (fread(sink, 1, sizeof sink, p) > 0) {
        }
        pclose(p);
      } else {
        total = -1;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        j->bytes_read = total;
        j->done = true;
      }
      cv_done.notify_all();
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* reader_create(int workers) { return new Pool(std::max(1, workers)); }

long reader_submit(void* pool, const char* cmd, uint8_t* buf, long capacity) {
  auto* p = static_cast<Pool*>(pool);
  long id;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    id = p->next_id++;
    p->jobs.emplace(id, Job{cmd, buf, capacity});
    p->queue.push_back(id);
  }
  p->cv_work.notify_one();
  return id;
}

long reader_wait(void* pool, long id) {
  auto* p = static_cast<Pool*>(pool);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [p, id] { return p->jobs.at(id).done; });
  long bytes = p->jobs.at(id).bytes_read;
  p->jobs.erase(id);  // bounded memory for long-lived pools
  return bytes;
}

void reader_destroy(void* pool) { delete static_cast<Pool*>(pool); }

}  // extern "C"

// -------------------------------------------------------------- soft-DTW

namespace {

inline float softmin3(float a, float b, float c, float gamma) {
  const float n0 = -a / gamma, n1 = -b / gamma, n2 = -c / gamma;
  const float mx = std::max(n0, std::max(n1, n2));
  const float s = std::exp(n0 - mx) + std::exp(n1 - mx) + std::exp(n2 - mx);
  return -gamma * (std::log(s) + mx);
}

void softdtw_fwd_one(const float* D, float* R, int N, int M, float gamma,
                     int bandwidth) {
  const int W = M + 2;
  const float INF = std::numeric_limits<float>::infinity();
  std::fill(R, R + (N + 2) * W, INF);
  R[0] = 0.0f;
  for (int j = 1; j <= M; ++j) {
    for (int i = 1; i <= N; ++i) {
      if (bandwidth > 0 && std::abs(i - j) > bandwidth) continue;
      const float sm = softmin3(R[(i - 1) * W + (j - 1)], R[(i - 1) * W + j],
                                R[i * W + (j - 1)], gamma);
      R[i * W + j] = D[(i - 1) * M + (j - 1)] + sm;
    }
  }
}

void softdtw_bwd_one(const float* Din, const float* Rin, float grad,
                     float* E_out, int N, int M, float gamma, int bandwidth) {
  const int W = M + 2;
  const float INF = std::numeric_limits<float>::infinity();
  std::vector<float> D((N + 2) * W, 0.0f), R(Rin, Rin + (N + 2) * W),
      E((N + 2) * W, 0.0f);
  for (int i = 1; i <= N; ++i)
    for (int j = 1; j <= M; ++j) D[i * W + j] = Din[(i - 1) * M + (j - 1)];
  for (int i = 0; i < N + 2; ++i) R[i * W + (M + 1)] = -INF;
  for (int j = 0; j < M + 2; ++j) R[(N + 1) * W + j] = -INF;
  R[(N + 1) * W + (M + 1)] = R[N * W + M];
  E[(N + 1) * W + (M + 1)] = 1.0f;
  for (int j = M; j >= 1; --j) {
    for (int i = N; i >= 1; --i) {
      if (std::isinf(R[i * W + j])) R[i * W + j] = -INF;
      if (bandwidth > 0 && std::abs(i - j) > bandwidth) continue;
      const float r = R[i * W + j];
      const float a =
          std::exp((R[(i + 1) * W + j] - r - D[(i + 1) * W + j]) / gamma);
      const float b =
          std::exp((R[i * W + (j + 1)] - r - D[i * W + (j + 1)]) / gamma);
      const float c = std::exp(
          (R[(i + 1) * W + (j + 1)] - r - D[(i + 1) * W + (j + 1)]) / gamma);
      E[i * W + j] = E[(i + 1) * W + j] * a + E[i * W + (j + 1)] * b +
                     E[(i + 1) * W + (j + 1)] * c;
    }
  }
  for (int i = 1; i <= N; ++i)
    for (int j = 1; j <= M; ++j)
      E_out[(i - 1) * M + (j - 1)] = grad * E[i * W + j];
}

void parallel_over_batch(int B, const std::function<void(int)>& fn) {
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int n_threads = std::max(1, std::min(B, hw));
  std::vector<std::thread> ts;
  std::mutex mu;
  int next = 0;
  for (int t = 0; t < n_threads; ++t) {
    ts.emplace_back([&] {
      for (;;) {
        int b;
        {
          std::lock_guard<std::mutex> lk(mu);
          if (next >= B) return;
          b = next++;
        }
        fn(b);
      }
    });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// D: (B, N, M) row-major; R out: (B, N+2, M+2); value out: (B,)
void softdtw_forward_cpu(const float* D, float* R, float* value, int B, int N,
                         int M, float gamma, int bandwidth) {
  parallel_over_batch(B, [&](int b) {
    float* Rb = R + static_cast<long>(b) * (N + 2) * (M + 2);
    softdtw_fwd_one(D + static_cast<long>(b) * N * M, Rb, N, M, gamma,
                    bandwidth);
    value[b] = Rb[N * (M + 2) + M];
  });
}

// grad_out: (B,); E out: (B, N, M) = grad * dvalue/dD
void softdtw_backward_cpu(const float* D, const float* R,
                          const float* grad_out, float* E, int B, int N,
                          int M, float gamma, int bandwidth) {
  parallel_over_batch(B, [&](int b) {
    softdtw_bwd_one(D + static_cast<long>(b) * N * M,
                    R + static_cast<long>(b) * (N + 2) * (M + 2), grad_out[b],
                    E + static_cast<long>(b) * N * M, N, M, gamma, bandwidth);
  });
}

}  // extern "C"
