// Native host runtime for control_box_rst_tpu.
//
// Ref parity: the reference's real-time plumbing is C++ —
//   corbo::Rate (src/core/include/corbo-core/time.h:353: precise loop-rate
//   sleeping), thread priority helper (src/core/include/corbo-core/
//   threads.h:49), the threaded simulated plant's fixed-rate loop
//   (simulated_plant_threaded.h:52,110), and the streaming signal sink
//   (signal_target_rpc.h:55).
//
// The TPU build keeps the numeric hot path on-device (JAX), but the *host*
// runtime that drives real plants still needs drift-free deadlines and
// GIL-free logging; that is this file:
//   - Rate: CLOCK_MONOTONIC absolute-deadline sleeping (no cumulative drift,
//     unlike Python time.sleep), with overrun accounting.
//   - set_realtime_priority: SCHED_FIFO best-effort escalation.
//   - SignalWriter: lock-free-ish ring buffer + background flush thread
//     writing fixed-size binary records (t, values[dim]) so a Python
//     control loop never blocks on disk I/O.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Build: g++ -O2 -shared -fPIC -o libcbrst_runtime.so runtime.cpp -lpthread

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <pthread.h>
#include <sched.h>
#include <time.h>

namespace {

constexpr int64_t kNsPerSec = 1000000000LL;

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * kNsPerSec + ts.tv_nsec;
}

void sleep_until_ns(int64_t deadline) {
  timespec ts;
  ts.tv_sec = deadline / kNsPerSec;
  ts.tv_nsec = deadline % kNsPerSec;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) != 0) {
    // retry on EINTR
  }
}

struct Rate {
  int64_t period_ns;
  int64_t next_deadline;
  int64_t overruns;
  int64_t cycles;
};

struct SignalWriter {
  FILE* file;
  int dim;
  size_t capacity;            // number of records
  size_t record_floats;       // 1 (time) + dim
  std::vector<double> ring;   // capacity * record_floats
  std::atomic<size_t> head;   // producer index (records)
  std::atomic<size_t> tail;   // consumer index (records)
  std::atomic<bool> stop;
  std::atomic<int64_t> dropped;
  std::thread flusher;
};

void flusher_main(SignalWriter* w) {
  std::vector<double> buf;
  while (true) {
    size_t t = w->tail.load(std::memory_order_acquire);
    size_t h = w->head.load(std::memory_order_acquire);
    if (t == h) {
      if (w->stop.load(std::memory_order_acquire)) break;
      std::this_thread::sleep_for(std::chrono::milliseconds(2));
      continue;
    }
    size_t n = (h - t);
    for (size_t i = 0; i < n; ++i) {
      size_t idx = (t + i) % w->capacity;
      fwrite(&w->ring[idx * w->record_floats], sizeof(double),
             w->record_floats, w->file);
    }
    fflush(w->file);
    w->tail.store(t + n, std::memory_order_release);
  }
  fflush(w->file);
}

}  // namespace

extern "C" {

// ---------------- Rate (ref: corbo::Rate, time.h:353) ----------------

void* rate_create(double period_s) {
  Rate* r = new Rate();
  r->period_ns = static_cast<int64_t>(period_s * 1e9);
  r->next_deadline = now_ns() + r->period_ns;
  r->overruns = 0;
  r->cycles = 0;
  return r;
}

// Sleep until the next period boundary. Returns slack in seconds
// (negative = overrun; the deadline then resets from now, like
// corbo::Rate::sleep's behavior on missed cycles).
double rate_sleep(void* handle) {
  Rate* r = static_cast<Rate*>(handle);
  int64_t now = now_ns();
  double slack = static_cast<double>(r->next_deadline - now) / 1e9;
  if (now <= r->next_deadline) {
    sleep_until_ns(r->next_deadline);
    r->next_deadline += r->period_ns;
  } else {
    r->overruns++;
    r->next_deadline = now + r->period_ns;
  }
  r->cycles++;
  return slack;
}

void rate_reset(void* handle) {
  Rate* r = static_cast<Rate*>(handle);
  r->next_deadline = now_ns() + r->period_ns;
}

long long rate_overruns(void* handle) {
  return static_cast<Rate*>(handle)->overruns;
}

void rate_destroy(void* handle) { delete static_cast<Rate*>(handle); }

double monotonic_time() { return static_cast<double>(now_ns()) / 1e9; }

// ------------- thread priority (ref: threads.h:49) -------------------

// Best effort; returns 0 on success, errno otherwise (needs CAP_SYS_NICE).
int set_realtime_priority(int priority) {
  sched_param sp;
  std::memset(&sp, 0, sizeof(sp));
  sp.sched_priority = priority;
  if (pthread_setschedparam(pthread_self(), SCHED_FIFO, &sp) != 0) {
    return 1;
  }
  return 0;
}

// ------------- binary signal writer ----------------------------------

void* writer_create(const char* path, int dim, int capacity) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  SignalWriter* w = new SignalWriter();
  w->file = f;
  w->dim = dim;
  w->capacity = static_cast<size_t>(capacity);
  w->record_floats = static_cast<size_t>(dim) + 1;
  w->ring.resize(w->capacity * w->record_floats);
  w->head.store(0);
  w->tail.store(0);
  w->stop.store(false);
  w->dropped.store(0);
  // header: magic, version, dim
  double header[3] = {7557.0, 1.0, static_cast<double>(dim)};
  fwrite(header, sizeof(double), 3, f);
  w->flusher = std::thread(flusher_main, w);
  return w;
}

// Non-blocking push; drops the record (and counts it) if the ring is full.
int writer_push(void* handle, double t, const double* values) {
  SignalWriter* w = static_cast<SignalWriter*>(handle);
  size_t h = w->head.load(std::memory_order_relaxed);
  size_t tl = w->tail.load(std::memory_order_acquire);
  if (h - tl >= w->capacity) {
    w->dropped.fetch_add(1, std::memory_order_relaxed);
    return 1;
  }
  size_t idx = (h % w->capacity) * w->record_floats;
  w->ring[idx] = t;
  std::memcpy(&w->ring[idx + 1], values, sizeof(double) * w->dim);
  w->head.store(h + 1, std::memory_order_release);
  return 0;
}

long long writer_dropped(void* handle) {
  return static_cast<SignalWriter*>(handle)->dropped.load();
}

void writer_close(void* handle) {
  SignalWriter* w = static_cast<SignalWriter*>(handle);
  w->stop.store(true, std::memory_order_release);
  w->flusher.join();
  fclose(w->file);
  delete w;
}

}  // extern "C"
