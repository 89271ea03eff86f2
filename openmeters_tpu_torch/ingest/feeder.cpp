// Synthetic real-time producer threads for the serving loop + ingest bench.
//
// The reference validates its transport under a live PipeWire daemon
// (live_tests.rs:153-342, "spawn the real middleware").  Headless analogue:
// native feeder threads that push phase-continuous tone PCM into the
// transport at a real-time pace (or flat out for ingest throughput
// benchmarks), so the serve loop and its benchmarks exercise the same
// producer->ring->assembler path a real capture source would, at stream
// counts Python producer threads cannot reach.
//
// Zero per-sample math on the push path: the tone is a precomputed
// cycle-aligned buffer (freq = rate / 48, exactly periodic), amplitude
// variants prebuilt per stream-index class, so each push is a pointer into
// static data.

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {
int32_t om_push_pcm(void* h, uint32_t stream, const float* samples,
                    uint32_t frames, uint64_t timestamp_ns);
uint64_t om_buffered_frames(void* h, uint32_t stream);
}

namespace {

constexpr uint32_t kCycle = 48;  // frames per tone period (freq = rate/48)
constexpr uint32_t kAmpClasses = 8;

struct Feeder {
  void* transport = nullptr;
  uint32_t begin = 0, end = 0;
  uint32_t frames = 256;  // frames per push
  double rate = 48000.0;
  bool realtime = true;
  uint64_t max_buffered = 0;  // flat-out backpressure guard (frames)

  std::vector<std::vector<float>> tone;  // [amp_class][(frames+kCycle)*2]
  std::vector<uint64_t> pushed;          // per stream, frames
  std::atomic<uint64_t> ok_pushes{0};
  std::atomic<uint64_t> failed_pushes{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;
};

void worker(Feeder* f, uint32_t begin, uint32_t end) {
  using clock = std::chrono::steady_clock;
  const auto hop = std::chrono::nanoseconds(
      (uint64_t)(f->frames * 1e9 / f->rate));
  auto next = clock::now() + hop;
  const double ns_per_frame = 1e9 / f->rate;
  while (!f->stop.load(std::memory_order_relaxed)) {
    for (uint32_t s = begin; s < end; ++s) {
      if (!f->realtime && f->max_buffered &&
          om_buffered_frames(f->transport, s) + f->frames > f->max_buffered) {
        continue;  // backpressure: ring nearly full, try next round
      }
      uint64_t done = f->pushed[s];
      uint32_t phase = (uint32_t)(done % kCycle);
      const float* src =
          f->tone[s % kAmpClasses].data() + (size_t)phase * 2;
      uint64_t ts = (uint64_t)((double)done * ns_per_frame + 0.5);
      if (om_push_pcm(f->transport, s, src, f->frames, ts) == 0) {
        f->pushed[s] = done + f->frames;
        f->ok_pushes.fetch_add(1, std::memory_order_relaxed);
      } else {
        f->failed_pushes.fetch_add(1, std::memory_order_relaxed);
      }
    }
    if (f->realtime) {
      std::this_thread::sleep_until(next);
      next += hop;
      // resync if we fell behind (a stalled consumer must not turn pacing
      // into a flat-out burst that overflows the ring)
      auto now = clock::now();
      if (next < now) next = now + hop;
    }
  }
}

}  // namespace

extern "C" {

// Start feeder threads pushing stereo tone PCM into streams [begin, end).
// realtime != 0 paces pushes to the sample rate; 0 pushes flat out with a
// backpressure guard at max_buffered_frames.
void* om_feeder_start(void* transport, uint32_t begin, uint32_t end,
                      uint32_t frames, double rate, float amplitude,
                      uint32_t realtime, uint64_t max_buffered_frames,
                      uint32_t n_threads) {
  auto* f = new Feeder();
  f->transport = transport;
  f->begin = begin;
  f->end = end;
  f->frames = frames;
  f->rate = rate;
  f->realtime = realtime != 0;
  f->max_buffered = max_buffered_frames;
  f->pushed.assign(end, 0);

  // prebuilt stereo tone blocks: frames + one extra cycle so any phase
  // offset yields a contiguous [frames, 2] window
  f->tone.resize(kAmpClasses);
  for (uint32_t a = 0; a < kAmpClasses; ++a) {
    float amp = amplitude * (0.3f + 0.7f * (float)(a + 1) / kAmpClasses);
    auto& buf = f->tone[a];
    buf.resize((size_t)(frames + kCycle) * 2);
    for (uint32_t i = 0; i < frames + kCycle; ++i) {
      float v = amp * std::sin(2.0 * M_PI * (double)(i % kCycle) / kCycle);
      buf[(size_t)i * 2] = v;
      buf[(size_t)i * 2 + 1] = v;
    }
  }

  if (n_threads == 0) n_threads = 1;
  uint32_t span = end - begin;
  uint32_t per = (span + n_threads - 1) / n_threads;
  for (uint32_t i = 0; i < n_threads && begin + i * per < end; ++i) {
    uint32_t lo = begin + i * per;
    uint32_t hi = lo + per < end ? lo + per : end;
    f->threads.emplace_back(worker, f, lo, hi);
  }
  return f;
}

void om_feeder_stop(void* fp) {
  auto* f = static_cast<Feeder*>(fp);
  f->stop.store(true, std::memory_order_relaxed);
  for (auto& t : f->threads) t.join();
  delete f;
}

uint64_t om_feeder_ok(void* fp) {
  return static_cast<Feeder*>(fp)->ok_pushes.load(std::memory_order_relaxed);
}

uint64_t om_feeder_failed(void* fp) {
  return static_cast<Feeder*>(fp)->failed_pushes.load(std::memory_order_relaxed);
}

}  // extern "C"
