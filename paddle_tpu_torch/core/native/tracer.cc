// Host tracer: low-overhead RecordEvent buffer with chrome-trace export.
//
// The port's copy of paddle_tpu/core/native/tracer.cc (Paddle's
// host_tracer.cc RecordEvent and chrometracing_logger.cc are the
// originals). Device-side timing comes from torch.profiler (CUPTI); this
// buffer captures framework host events (RecordEvent ranges) with ns
// timestamps and near-zero per-event cost, then Python renders chrome
// trace JSON. Names longer than 63 bytes are cut.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <mutex>
#include <vector>

namespace {

struct Event {
  char name[64];
  int64_t start_ns;
  int64_t end_ns;
  int32_t tid;
  int32_t kind;  // 0 = duration, 1 = instant, 2 = counter(value=end_ns)
};

std::mutex g_mu;
std::vector<Event> g_events;
std::atomic<bool> g_enabled{false};

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

}  // namespace

extern "C" {

void pt_tracer_enable(int on) { g_enabled.store(on != 0); }

int pt_tracer_enabled() { return g_enabled.load() ? 1 : 0; }

int64_t pt_tracer_now_ns() { return now_ns(); }

// Record a completed duration event.
void pt_tracer_record(const char* name, int64_t start_ns, int64_t end_ns,
                      int32_t tid, int32_t kind) {
  if (!g_enabled.load()) return;
  Event e;
  std::strncpy(e.name, name ? name : "", sizeof(e.name) - 1);
  e.name[sizeof(e.name) - 1] = 0;
  e.start_ns = start_ns;
  e.end_ns = end_ns;
  e.tid = tid;
  e.kind = kind;
  std::lock_guard<std::mutex> lk(g_mu);
  g_events.push_back(e);
}

size_t pt_tracer_count() {
  std::lock_guard<std::mutex> lk(g_mu);
  return g_events.size();
}

// Copy up to `cap` events into caller-provided parallel arrays; returns n.
// names buffer must be cap*64 bytes.
size_t pt_tracer_drain(char* names, int64_t* starts, int64_t* ends,
                       int32_t* tids, int32_t* kinds, size_t cap) {
  std::lock_guard<std::mutex> lk(g_mu);
  size_t n = g_events.size() < cap ? g_events.size() : cap;
  for (size_t i = 0; i < n; ++i) {
    std::memcpy(names + i * 64, g_events[i].name, 64);
    starts[i] = g_events[i].start_ns;
    ends[i] = g_events[i].end_ns;
    tids[i] = g_events[i].tid;
    kinds[i] = g_events[i].kind;
  }
  g_events.erase(g_events.begin(), g_events.begin() + n);
  return n;
}

void pt_tracer_clear() {
  std::lock_guard<std::mutex> lk(g_mu);
  g_events.clear();
}

}  // extern "C"
