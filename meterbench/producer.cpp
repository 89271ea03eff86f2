// The benchmark's PCM producer: native threads that push programme clips
// into the port's transport, outside the interpreter lock.
//
// Started from a frozen copy of the port's ingest/feeder.cpp and changed to
// push PCM from a host pool of stereo clips instead of a tone: stream s
// reads clip clip_of[s] cyclically from frame offset_of[s], so the samples
// a stream receives are fixed by the pool and the two arrays alone.  Pushes
// go through the transport's own C entry om_push_pcm, whose address (and
// om_buffered_frames') the caller passes in, so this library links nothing
// of the program.  Flat out under backpressure: a stream is skipped while
// its buffered frames plus one push would pass max_buffered.  Each thread
// sleeps kRoundSleep after every round over its streams: with pushes of
// many hops and a buffer of a second, that keeps the rings full while the
// threads stay off the cores and off the cache lines the assembler uses.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr auto kRoundSleep = std::chrono::milliseconds(2);

using push_fn = int32_t (*)(void*, uint32_t, const float*, uint32_t, uint64_t);
using buffered_fn = uint64_t (*)(void*, uint32_t);

struct Producer {
  void* transport = nullptr;
  push_fn push = nullptr;
  buffered_fn buffered = nullptr;
  const float* pool = nullptr;  // [clips, clip_frames, 2]
  uint64_t clip_frames = 0;
  std::vector<uint32_t> clip_of;
  std::vector<uint64_t> offset_of;
  std::vector<uint64_t> pushed;  // per stream, frames
  uint32_t frames = 1024;        // frames per push, at most
  uint64_t max_buffered = 0;
  double ns_per_frame = 1e9 / 48000.0;
  std::atomic<uint64_t> ok_pushes{0};
  std::atomic<uint64_t> failed_pushes{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;
};

void worker(Producer* p, uint32_t begin, uint32_t end) {
  while (!p->stop.load(std::memory_order_relaxed)) {
    for (uint32_t s = begin; s < end; ++s) {
      if (p->buffered(p->transport, s) + p->frames > p->max_buffered) continue;
      uint64_t done = p->pushed[s];
      uint64_t pos = (p->offset_of[s] + done) % p->clip_frames;
      uint64_t left = p->clip_frames - pos;  // a push never crosses the clip's end
      uint32_t n = left < p->frames ? (uint32_t)left : p->frames;
      const float* src = p->pool + ((uint64_t)p->clip_of[s] * p->clip_frames + pos) * 2;
      uint64_t ts = (uint64_t)((double)done * p->ns_per_frame + 0.5);
      if (p->push(p->transport, s, src, n, ts) == 0) {
        p->pushed[s] = done + n;
        p->ok_pushes.fetch_add(1, std::memory_order_relaxed);
      } else {
        p->failed_pushes.fetch_add(1, std::memory_order_relaxed);
      }
    }
    std::this_thread::sleep_for(kRoundSleep);
  }
}

}  // namespace

extern "C" {

void* mb_producer_start(void* transport, void* push, void* buffered,
                        const float* pool, uint32_t clips, uint64_t clip_frames,
                        const uint32_t* clip_of, const uint64_t* offset_of,
                        uint32_t n_streams, uint32_t frames, uint64_t max_buffered,
                        double sample_rate, uint32_t n_threads) {
  if (clips == 0 || clip_frames == 0 || n_streams == 0 || frames == 0) return nullptr;
  auto* p = new Producer();
  p->transport = transport;
  p->push = reinterpret_cast<push_fn>(push);
  p->buffered = reinterpret_cast<buffered_fn>(buffered);
  p->pool = pool;
  p->clip_frames = clip_frames;
  p->clip_of.assign(clip_of, clip_of + n_streams);
  p->offset_of.assign(offset_of, offset_of + n_streams);
  p->pushed.assign(n_streams, 0);
  p->frames = frames;
  p->max_buffered = max_buffered;
  p->ns_per_frame = 1e9 / sample_rate;
  if (n_threads == 0) n_threads = 1;
  uint32_t per = (n_streams + n_threads - 1) / n_threads;
  for (uint32_t i = 0; i < n_threads && i * per < n_streams; ++i) {
    uint32_t lo = i * per;
    uint32_t hi = lo + per < n_streams ? lo + per : n_streams;
    p->threads.emplace_back(worker, p, lo, hi);
  }
  return p;
}

// Stop and join the threads; the counts stay readable until mb_producer_free.
void mb_producer_stop(void* h) {
  auto* p = static_cast<Producer*>(h);
  p->stop.store(true, std::memory_order_relaxed);
  for (auto& t : p->threads) t.join();
  p->threads.clear();
}

void mb_producer_free(void* h) { delete static_cast<Producer*>(h); }

uint64_t mb_producer_ok(void* h) {
  return static_cast<Producer*>(h)->ok_pushes.load(std::memory_order_relaxed);
}

uint64_t mb_producer_failed(void* h) {
  return static_cast<Producer*>(h)->failed_pushes.load(std::memory_order_relaxed);
}

// The fewest frames buffered over the streams (the prefill's wait).
uint64_t mb_producer_min_buffered(void* h) {
  auto* p = static_cast<Producer*>(h);
  uint64_t least = UINT64_MAX;
  for (uint32_t s = 0; s < p->pushed.size(); ++s) {
    uint64_t b = p->buffered(p->transport, s);
    if (b < least) least = b;
  }
  return least;
}

}  // extern "C"
