// Host emulation of the CUDA runtime, warp intrinsics and integer
// intrinsics that the warp kernels use (board_scan.cu, full3d_scan.cu, board_shared.cu,
// full3d_shared.cu, metropolis.cu, full3d_pallas.cu) and the gather and
// slice probes (probe_gather.cu, probe_slice.cu), so that a kernel's
// logic can be run and checked on a machine without a GPU or nvcc.  Built
// with g++ -std=c++20 -pthread by mcqueens_torch/kernels/host_emulation.py,
// which puts this directory first on the include path (so the sources'
// #include <cuda_runtime.h> finds this file) and rewrites two constructs
// g++ cannot parse: a launch `kernel<<<grid, block, smem, stream>>>(args)`
// becomes emu::launch(kernel, grid, block, smem, stream, args), and
// `extern __shared__ T name[];` a pointer to the block's shared memory.
//
// One fiber (ucontext) per CUDA thread, all on the calling OS thread; the
// blocks of a launch run one after another, the fibers of an even block
// round robin, each until it waits at a barrier, those of an odd block a
// warp at a time (each warp until it waits at __syncthreads or ends).  Each
// round resumes the fibers in a new pseudo-random order (a permutation
// drawn from a generator seeded alike at every launch, so that a run
// repeats), so the lanes a barrier releases run in no fixed order.  A
// warp-wide intrinsic is "write my slot, wait for the warp, read" (two slot
// banks used in turn, so no second wait), __syncwarp a wait for the warp,
// __syncthreads for the block.  As each lane runs as far as it can alone, a
// lane that reads what another lane stores between the same two barriers
// (a race on the card, hidden there by lanes that run converged) sees the
// store in some rounds and not in others, and so, in an odd block, does a
// warp that reads shared memory other warps have not yet written (a missing
// __syncthreads; the block's memory starts filled with 0xA5); a round of
// the scheduler in which no fiber arrives at a barrier or ends (lanes that
// reached different warp intrinsics) aborts the process with a message
// rather than hang, and so does a launch that runs over a minute (an
// endless loop).
//
// Shared memory has two models, chosen at each launch by MCQ_EMU_MEMORY.
// "ordered" (the default): one block memory, a store visible to every lane
// as soon as it is made, as above.  "delayed": the
// card's rule that only __syncwarp and __syncthreads (not a shuffle or a
// vote) order one thread's store before another thread's load.  Each
// thread works on its own copy of the block's shared memory; at
// __syncwarp its warp's stores reach the block's memory and its warp's
// copies are renewed from it, at __syncthreads the block's.  A thread
// that reads what another thread stored after the last such barrier they
// share sees the old value every time, and two threads that store
// different values to one byte between barriers are a race, which the
// launch reports (cudaGetLastError, and a line on stderr).  A 32-bit
// atomicAdd or atomicOr on shared memory acts on the block's memory at once
// in both models (as the card's shared-memory atomics do), and in the
// delayed one also on the calling thread's copy; another thread sees it
// after their next common barrier.  Not emulated: warp masks other than
// the full one, the device's expf rounding (the host's expf is used), the
// cache hints of __ldcs and __stcs.

#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <ucontext.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

using cudaStream_t = void*;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 4
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// The running fiber's thread and block (one OS thread runs them all).
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }

struct uint4 {
  unsigned x, y, z, w;
};

struct int4 {
  int x, y, z, w;
};

inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}

inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

template <typename T>
T __ldcs(const T* p) {
  return *p;
}

template <typename T>
void __stcs(T* p, T v) {
  *p = v;
}

inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}

inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}

inline float __int_as_float(int i) { return __uint_as_float((uint32_t)i); }

// Byte i of the result is |byte i of a - byte i of b|, the bytes unsigned.
inline unsigned __vabsdiffu4(unsigned a, unsigned b) {
  unsigned out = 0;
  for (int i = 0; i < 32; i += 8) {
    const int x = (int)((a >> i) & 0xFF), y = (int)((b >> i) & 0xFF);
    out |= (unsigned)(x > y ? x - y : y - x) << i;
  }
  return out;
}

// Byte i of the result is byte (s >> 4i) & 7 of the eight bytes of y:x.
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned out = 0;
  for (int i = 0; i < 4; ++i) {
    out |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  }
  return out;
}

namespace emu {

constexpr size_t kStack = 256 * 1024;

struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack{new char[kStack]};
  unsigned tid = 0;
  bool done = false;
};

inline ucontext_t scheduler;
inline Fiber* current = nullptr;
inline long progress = 0;  // arrivals at barriers and fibers ended
inline const std::function<void()>* body = nullptr;

inline void yield() { swapcontext(&current->ctx, &scheduler); }

class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  // The last thread to arrive runs `done(lo, hi)`, if given, before any
  // waiting thread goes on.
  void wait(void (*done)(unsigned, unsigned) = nullptr, unsigned lo = 0,
            unsigned hi = 0) {
    ++progress;
    const unsigned long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      if (done) done(lo, hi);
      ++gen_;
      return;
    }
    while (gen_ == gen) yield();
  }

 private:
  int n_, count_ = 0;
  unsigned long gen_ = 0;
};

struct Warp {
  Barrier bar{32};
  uint64_t slot[2][32];
  int bank[32] = {};  // each lane's next slot bank
};

struct Block {
  Block(unsigned threads, size_t smem_bytes, bool delayed)
      : bar(threads), smem(smem_bytes + 16, 0xA5) {
    for (unsigned w = 0; w < threads / 32; ++w) {
      warps.push_back(std::make_unique<Warp>());
    }
    if (delayed) {
      views.assign(threads, smem);
      bases.assign(threads, smem);
    }
  }
  Barrier bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<uint8_t> smem;  // filled with 0xA5: never read unwritten
  // The delayed model: each thread's copy, and the block's memory as that
  // copy last took it.
  std::vector<std::vector<uint8_t>> views, bases;
};

inline Block* block = nullptr;
inline bool raced = false;  // this launch stored racing values

inline void* shared_memory() {
  return block->views.empty() ? block->smem.data()
                              : block->views[threadIdx.x].data();
}

// The delayed model's barrier for threads [lo, hi): their stores into the
// block's memory, then their copies renewed from it.
inline void publish(unsigned lo, unsigned hi) {
  Block& b = *block;
  if (b.views.empty()) return;
  const size_t n = b.smem.size();
  for (unsigned t = lo; t < hi; ++t) {
    const uint8_t* v = b.views[t].data();
    const uint8_t* base = b.bases[t].data();
    for (size_t i = 0; i < n; i += 8) {
      if (memcmp(v + i, base + i, n - i < 8 ? n - i : 8) == 0) continue;
      for (size_t k = i; k < i + 8 && k < n; ++k) {
        if (v[k] == base[k]) continue;
        if (b.smem[k] != base[k] && b.smem[k] != v[k] && !raced) {
          raced = true;
          fprintf(stderr, "emu: block %u: thread %u stored %u at shared "
                  "byte %zu, another thread %u since their last common "
                  "barrier\n", blockIdx.x, t, v[k], k, b.smem[k]);
        }
        b.smem[k] = v[k];
      }
    }
  }
  for (unsigned t = lo; t < hi; ++t) {
    memcpy(b.views[t].data(), b.smem.data(), n);
    memcpy(b.bases[t].data(), b.smem.data(), n);
  }
}

inline Warp& my_warp() { return *block->warps[threadIdx.x / 32]; }

// *p = f(*p) for a word of shared (or device) memory; returns the old
// word.  In the delayed model p lies in the calling thread's copy: the
// block's word is the one updated, and the copy and its base take it.
template <typename F>
unsigned atomic_rmw(unsigned* p, F f) {
  Block* b = block;
  if (b && !b->views.empty()) {
    uint8_t* view = b->views[threadIdx.x].data();
    const size_t k = (size_t)((uint8_t*)p - view);
    if ((uint8_t*)p >= view && k + 4 <= b->smem.size()) {
      unsigned old, nu;
      memcpy(&old, &b->smem[k], 4);
      nu = f(old);
      memcpy(&b->smem[k], &nu, 4);
      memcpy(view + k, &nu, 4);
      memcpy(b->bases[threadIdx.x].data() + k, &nu, 4);
      return old;
    }
  }
  const unsigned old = *p;
  *p = f(old);
  return old;
}

// Publish this lane's word, wait for the warp; returns the bank to read.
inline uint64_t* exchange(uint64_t bits) {
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32, b = w.bank[lane];
  w.bank[lane] = b ^ 1;
  w.slot[b][lane] = bits;
  w.bar.wait();
  return w.slot[b];
}

template <typename T>
T shfl(T v, int src) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "shfl of a wide type");
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  bits = exchange(bits)[src & 31];
  T out;
  memcpy(&out, &bits, sizeof(T));
  return out;
}

inline int reduce_add(int v) {
  const uint64_t* slot = exchange((uint64_t)(uint32_t)v);
  uint32_t sum = 0;
  for (int l = 0; l < 32; ++l) sum += (uint32_t)slot[l];
  return (int)sum;
}

inline int reduce_max(int v) {
  const uint64_t* slot = exchange((uint64_t)(uint32_t)v);
  int m = (int)(uint32_t)slot[0];
  for (int l = 1; l < 32; ++l) m = max(m, (int)(uint32_t)slot[l]);
  return m;
}

inline unsigned ballot(bool p) {
  const uint64_t* slot = exchange(p ? 1 : 0);
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l) bits |= (slot[l] ? 1u : 0u) << l;
  return bits;
}

inline bool any(bool p) {
  const uint64_t* slot = exchange(p ? 1 : 0);
  for (int l = 0; l < 32; ++l) {
    if (slot[l]) return true;
  }
  return false;
}

// Aborts the process unless destroyed within `seconds`.
class Watchdog {
 public:
  explicit Watchdog(int seconds)
      : thread_([this, seconds] {
          std::unique_lock<std::mutex> lock(mu_);
          if (!cv_.wait_for(lock, std::chrono::seconds(seconds),
                            [this] { return done_; })) {
            fprintf(stderr, "emu: a launch ran over %d s (an endless "
                    "loop?)\n", seconds);
            abort();
          }
        }) {}
  ~Watchdog() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      done_ = true;
    }
    cv_.notify_all();
    thread_.join();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  bool done_ = false;
  std::thread thread_;
};

inline void trampoline() {
  (*body)();
  current->done = true;
  ++progress;
}  // returns to the scheduler through uc_link

// kernel<<<grid, block, smem, stream>>>(args...), run to its end.
template <typename... P, typename... A>
void launch(void (*kernel)(P...), dim3 grid, dim3 threads, size_t smem,
            cudaStream_t, A... args) {
  if (threads.x % 32 || threads.y != 1 || threads.z != 1 || grid.y != 1 ||
      grid.z != 1) {
    fprintf(stderr, "emu: only 1-D launches of whole warps\n");
    abort();
  }
  const Watchdog watchdog(60);
  const char* memory = getenv("MCQ_EMU_MEMORY");
  const bool delayed = memory && !strcmp(memory, "delayed");
  if (memory && !delayed && strcmp(memory, "ordered")) {
    fprintf(stderr, "emu: MCQ_EMU_MEMORY is ordered or delayed, not %s\n",
            memory);
    abort();
  }
  raced = false;
  gridDim = grid;
  blockDim = threads;
  const std::function<void()> run = [&] { kernel(args...); };
  body = &run;
  std::vector<Fiber> fibers(threads.x);
  std::vector<unsigned> order(threads.x);
  uint64_t rng = 0x9E3779B97F4A7C15ull;  // the same orders at every launch
  const auto shuffle = [&](unsigned lo, unsigned hi) {
    for (unsigned k = hi - 1; k > lo; --k) {
      rng ^= rng << 13;
      rng ^= rng >> 7;
      rng ^= rng << 17;
      std::swap(order[k], order[lo + rng % (k - lo + 1)]);
    }
  };
  for (unsigned b = 0; b < grid.x; ++b) {
    Block blk(threads.x, smem, delayed);
    block = &blk;
    blockIdx = dim3(b);
    for (unsigned t = 0; t < threads.x; ++t) {
      order[t] = t;
      Fiber& f = fibers[t];
      f.tid = t;
      f.done = false;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = &scheduler;
      makecontext(&f.ctx, trampoline, 0);
    }
    // Even blocks run their fibers round robin; odd blocks run one warp at
    // a time until it waits at __syncthreads or ends, so that a warp reads
    // shared memory before the other warps have written it.
    const unsigned span = b % 2 ? 32 : threads.x;
    for (unsigned live = threads.x; live;) {
      const long before = progress;
      live = 0;
      for (unsigned w0 = 0; w0 < threads.x; w0 += span) {
        for (long moved = -1; moved != progress;) {
          moved = progress;
          shuffle(w0, w0 + span);
          for (unsigned k = w0; k < w0 + span; ++k) {
            Fiber& f = fibers[order[k]];
            if (f.done) continue;
            current = &f;
            threadIdx = dim3(f.tid);
            swapcontext(&scheduler, &f.ctx);
          }
          if (span == threads.x) break;
        }
      }
      for (const Fiber& f : fibers) live += !f.done;
      if (live && progress == before) {
        fprintf(stderr, "emu: block %u stuck with %u threads waiting (a "
                "warp intrinsic reached on diverged paths?)\n", b, live);
        abort();
      }
    }
  }
  block = nullptr;
  current = nullptr;
}

}  // namespace emu

template <typename T>
T __shfl_sync(unsigned, T v, int src) {
  return emu::shfl(v, src);
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu::shfl(v, (int)(threadIdx.x % 32) ^ lane_mask);
}
inline int __reduce_add_sync(unsigned, int v) { return emu::reduce_add(v); }
inline int __reduce_max_sync(unsigned, int v) { return emu::reduce_max(v); }
inline int __any_sync(unsigned, int p) { return emu::any(p != 0); }
inline unsigned __ballot_sync(unsigned, int p) { return emu::ballot(p != 0); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return emu::atomic_rmw(p, [v](unsigned o) { return o + v; });
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return emu::atomic_rmw(p, [v](unsigned o) { return o | v; });
}
inline void __syncthreads() {
  emu::block->bar.wait(emu::publish, 0, blockDim.x);
}
inline void __syncwarp() {
  const unsigned w0 = threadIdx.x & ~31u;
  emu::my_warp().bar.wait(emu::publish, w0, w0 + 32);
}
inline cudaError_t cudaGetLastError() {
  return emu::raced ? cudaErrorLaunchFailure : cudaSuccess;
}
