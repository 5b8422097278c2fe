// tensorops_native: the rebuild's native runtime layer.
//
// Role in the architecture: the reference reaches native code through
// hmatrix -> C BLAS/LAPACK for its dense math (stack.yaml:40-45,
// src/TensorOps/BLAS/HMat.hs); its data pipeline is mnist-idx + zlib.
// Here the device compute path is XLA (native via the runtime), and
// this library supplies the host-side native pieces:
//
//   * reference math kernels (generalized contraction `gmul` with the
//     reversed-contraction-axes convention of Types.hs:60-66, full index
//     reversal `transpose`) used by the NumPy oracle backend as an
//     independent, C-speed implementation;
//   * a threaded, double-buffered minibatch loader (shuffle + batch
//     assembly off the main thread) feeding the training loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// math kernels (float64, row-major)
// ---------------------------------------------------------------------------

// out[m, n] = sum_o x[m, o] * y[rev(o), n]
//   x shape: ms ++ os   (M = prod ms, O = prod os)
//   y shape: reverse(os) ++ ns  (N = prod ns)
// Row-major strides for the o_i axis (size d_i, i = 1..k in x order) inside
// y's layout (o_k, ..., o_1, n...):  stride_i = N * prod_{j<i} d_j.
void top_gmul(const double* x, const double* y, double* out,
              const int64_t* os, int lo,
              int64_t M, int64_t O, int64_t N) {
  std::vector<int64_t> ystride(lo), counter(lo, 0);
  {
    int64_t acc = N;
    for (int i = 0; i < lo; ++i) {  // i-th contraction dim of x
      ystride[i] = acc;
      acc *= os[i];
    }
  }
  for (int64_t m = 0; m < M; ++m) {
    const double* xm = x + m * O;
    double* om = out + m * N;
    std::memset(om, 0, sizeof(double) * N);
    std::fill(counter.begin(), counter.end(), 0);
    int64_t yoff = 0;
    for (int64_t o = 0; o < O; ++o) {
      const double xv = xm[o];
      const double* yo = y + yoff;
      if (xv != 0.0) {
        for (int64_t n = 0; n < N; ++n) om[n] += xv * yo[n];
      }
      // increment the o multi-index (last x-axis fastest: row-major)
      for (int i = lo - 1; i >= 0; --i) {
        yoff += ystride[i];
        if (++counter[i] < os[i]) break;
        yoff -= ystride[i] * os[i];
        counter[i] = 0;
      }
    }
  }
}

// Full index reversal: out[i_k, ..., i_1] = in[i_1, ..., i_k]
void top_transpose(const double* in, double* out, const int64_t* shape,
                   int rank) {
  if (rank <= 1) {
    int64_t n = rank == 0 ? 1 : shape[0];
    std::memcpy(out, in, sizeof(double) * n);
    return;
  }
  std::vector<int64_t> in_stride(rank), out_stride(rank);
  int64_t total = 1;
  {
    int64_t acc = 1;
    for (int i = rank - 1; i >= 0; --i) {
      in_stride[i] = acc;
      acc *= shape[i];
    }
    total = acc;
    acc = 1;
    // out dims are reversed: out_stride for in-axis i = stride of position
    // (rank-1-i) in the reversed-shape layout
    for (int i = 0; i < rank; ++i) {
      out_stride[i] = acc;
      acc *= shape[i];
    }
  }
  std::vector<int64_t> idx(rank, 0);
  int64_t ooff = 0;
  for (int64_t lin = 0; lin < total; ++lin) {
    out[ooff] = in[lin];
    for (int i = rank - 1; i >= 0; --i) {
      ooff += out_stride[i];
      if (++idx[i] < shape[i]) break;
      ooff -= out_stride[i] * shape[i];
      idx[i] = 0;
    }
  }
}

// axpy / dot / gemm-lite used by oracle micro-paths and sanity checks
void top_axpy(double a, const double* x, double* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] += a * x[i];
}

double top_dot(const double* x, const double* y, int64_t n) {
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) acc += x[i] * y[i];
  return acc;
}

// ---------------------------------------------------------------------------
// threaded minibatch loader
// ---------------------------------------------------------------------------

struct Batch {
  std::vector<float> x, y;
  std::vector<int64_t> idx;
};

struct Loader {
  const float* X;
  const float* Y;
  int64_t n, xdim, ydim, batch;
  uint64_t seed;
  bool drop_last;
  // index-only mode: fill() records the permutation slice and skips the
  // row memcpys entirely — the consumer gathers rows itself (on-device
  // for the chained training path, where assembling 13 MB batches on
  // one host thread could never feed a ~30k steps/s device)
  bool idx_only = false;

  std::vector<int64_t> perm;
  int64_t cursor = 0;
  uint64_t epoch = 0;

  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::deque<Batch> queue;
  size_t capacity = 4;
  std::thread worker;
  std::atomic<bool> stop{false};

  Loader(const float* X_, const float* Y_, int64_t n_, int64_t xdim_,
         int64_t ydim_, int64_t batch_, uint64_t seed_, bool drop_last_,
         bool idx_only_ = false)
      : X(X_), Y(Y_), n(n_), xdim(xdim_), ydim(ydim_), batch(batch_),
        seed(seed_), drop_last(drop_last_), idx_only(idx_only_) {
    perm.resize(n);
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    reshuffle();
    worker = std::thread([this] { run(); });
  }

  void reshuffle() {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (++epoch));
    std::shuffle(perm.begin(), perm.end(), rng);
    cursor = 0;
  }

  bool fill(Batch& b) {
    if (cursor >= n) reshuffle();
    int64_t take = std::min(batch, n - cursor);
    if (drop_last && take < batch) {
      reshuffle();
      take = std::min(batch, n);
    }
    b.idx.assign(perm.begin() + cursor, perm.begin() + cursor + take);
    if (!idx_only) {
      b.x.resize(take * xdim);
      b.y.resize(take * ydim);
      for (int64_t i = 0; i < take; ++i) {
        const int64_t src = perm[cursor + i];
        std::memcpy(&b.x[i * xdim], X + src * xdim, sizeof(float) * xdim);
        std::memcpy(&b.y[i * ydim], Y + src * ydim, sizeof(float) * ydim);
      }
    }
    cursor += take;
    return true;
  }

  void run() {
    while (!stop.load()) {
      Batch b;
      fill(b);
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [this] { return queue.size() < capacity || stop.load(); });
      if (stop.load()) return;
      queue.push_back(std::move(b));
      cv_empty.notify_one();
    }
  }

  bool pop(Batch& b) {
    std::unique_lock<std::mutex> lk(mu);
    cv_empty.wait(lk, [this] { return !queue.empty() || stop.load(); });
    if (queue.empty()) return false;
    b = std::move(queue.front());
    queue.pop_front();
    cv_full.notify_one();
    return true;
  }

  int64_t next(float* xout, float* yout) {
    Batch b;
    if (!pop(b)) return 0;
    const int64_t took = static_cast<int64_t>(b.x.size() / xdim);
    std::memcpy(xout, b.x.data(), sizeof(float) * b.x.size());
    std::memcpy(yout, b.y.data(), sizeof(float) * b.y.size());
    return took;
  }

  // indices of the next batch (same perm/cursor stream as next(), so
  // index-mode and gathered-mode loaders with one seed agree batch for
  // batch); idxout must hold `batch` int64s
  int64_t next_idx(int64_t* idxout) {
    Batch b;
    if (!pop(b)) return 0;
    std::memcpy(idxout, b.idx.data(), sizeof(int64_t) * b.idx.size());
    return static_cast<int64_t>(b.idx.size());
  }

  ~Loader() {
    stop.store(true);
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
  }
};

void* top_loader_create(const float* X, const float* Y, int64_t n,
                        int64_t xdim, int64_t ydim, int64_t batch,
                        uint64_t seed, int drop_last, int idx_only) {
  return new Loader(X, Y, n, xdim, ydim, batch, seed, drop_last != 0,
                    idx_only != 0);
}

int64_t top_loader_next(void* handle, float* xout, float* yout) {
  return static_cast<Loader*>(handle)->next(xout, yout);
}

int64_t top_loader_next_idx(void* handle, int64_t* idxout) {
  return static_cast<Loader*>(handle)->next_idx(idxout);
}

void top_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int top_abi_version() { return 2; }

}  // extern "C"
