// Native sensor ring buffer + gyro/accel interleaver.
//
// The native runtime counterpart of the reference Handler's sensor front door
// (rdvio/src/handler.cpp:56-152): bounded ring buffers for
// gyro/accel/fused samples, linear gyro-to-accel timestamp interpolation, and
// frame-interval assembly — so high-rate sensor ingestion costs no Python.
//
// C API:
//   rdvio_queue_create(capacity)                 -> handle
//   rdvio_queue_push_gyro(h, t, x, y, z)
//   rdvio_queue_push_accel(h, t, x, y, z)        (interleaves internally)
//   rdvio_queue_push_motion(h, t, w[3], a[3])    (pre-fused fast path)
//   rdvio_queue_fused_count(h)                   -> fused samples available
//   rdvio_queue_pop_interval(h, t_end, out, cap) -> n rows (t,wx,wy,wz,ax,ay,az)
//        pops all fused samples with t <= t_end (the frame-dispatch predicate
//        of reference handler.cpp:140-152)
//   rdvio_queue_destroy(h)

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>

namespace {

struct Sample {
  double t;
  double w[3];
  double a[3];
};

struct Vec3Stamped {
  double t;
  double v[3];
};

struct Queue {
  std::mutex mu;
  size_t capacity;
  std::deque<Vec3Stamped> gyro;
  std::deque<Vec3Stamped> accel;
  std::deque<Sample> fused;

  explicit Queue(size_t cap) : capacity(cap) {}

  void interleave_locked() {
    // reference handler.cpp:82-111: interpolate the gyro pair around each
    // accel timestamp
    while (!accel.empty() && gyro.size() >= 2) {
      const Vec3Stamped &acc = accel.front();
      if (acc.t < gyro[0].t) {
        accel.pop_front();
        continue;
      }
      if (acc.t > gyro[1].t) {
        gyro.pop_front();
        continue;
      }
      double denom = gyro[1].t - gyro[0].t;
      double lam = denom > 1e-12 ? (acc.t - gyro[0].t) / denom : 0.0;
      Sample s;
      s.t = acc.t;
      for (int k = 0; k < 3; ++k) {
        s.w[k] = gyro[0].v[k] + lam * (gyro[1].v[k] - gyro[0].v[k]);
        s.a[k] = acc.v[k];
      }
      push_fused_locked(s);
      accel.pop_front();
    }
  }

  void push_fused_locked(const Sample &s) {
    fused.push_back(s);
    while (fused.size() > capacity) fused.pop_front();
  }
};

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Queue>> g_queues;
int64_t g_next = 1;

Queue *lookup(int64_t id) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_queues.find(id);
  return it == g_queues.end() ? nullptr : it->second.get();
}

}  // namespace

extern "C" {

int64_t rdvio_queue_create(int64_t capacity) {
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t id = g_next++;
  g_queues[id] = std::make_unique<Queue>(capacity > 0 ? capacity : 8192);
  return id;
}

void rdvio_queue_push_gyro(int64_t id, double t, double x, double y, double z) {
  Queue *q = lookup(id);
  if (!q) return;
  std::lock_guard<std::mutex> lk(q->mu);
  q->gyro.push_back({t, {x, y, z}});
  q->interleave_locked();
}

void rdvio_queue_push_accel(int64_t id, double t, double x, double y, double z) {
  Queue *q = lookup(id);
  if (!q) return;
  std::lock_guard<std::mutex> lk(q->mu);
  q->accel.push_back({t, {x, y, z}});
  q->interleave_locked();
}

void rdvio_queue_push_motion(int64_t id, double t, const double *w, const double *a) {
  Queue *q = lookup(id);
  if (!q) return;
  std::lock_guard<std::mutex> lk(q->mu);
  Sample s;
  s.t = t;
  std::memcpy(s.w, w, 3 * sizeof(double));
  std::memcpy(s.a, a, 3 * sizeof(double));
  q->push_fused_locked(s);
}

int64_t rdvio_queue_fused_count(int64_t id) {
  Queue *q = lookup(id);
  if (!q) return -1;
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int64_t>(q->fused.size());
}

int64_t rdvio_queue_pop_interval(int64_t id, double t_end, double *out,
                                 int64_t cap) {
  Queue *q = lookup(id);
  if (!q) return -1;
  std::lock_guard<std::mutex> lk(q->mu);
  int64_t n = 0;
  while (!q->fused.empty() && q->fused.front().t <= t_end && n < cap) {
    const Sample &s = q->fused.front();
    double *o = out + n * 7;
    o[0] = s.t;
    o[1] = s.w[0]; o[2] = s.w[1]; o[3] = s.w[2];
    o[4] = s.a[0]; o[5] = s.a[1]; o[6] = s.a[2];
    q->fused.pop_front();
    ++n;
  }
  return n;
}

void rdvio_queue_destroy(int64_t id) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_queues.erase(id);
}

}  // extern "C"
