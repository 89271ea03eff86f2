// openmeters_tpu host ingest: multi-stream audio transport + batch assembly.
//
// Reference parity: src/infra/pipewire/transport.rs + src/meter.rs.  The
// reference connects one real-time producer (PipeWire callback) to one
// consumer (GUI frame clock) through a lock-free SPSC ring of pooled packets
// with a nanosecond timeline; gaps become Silence spans, overflow /
// discontinuity / format changes bump a fault epoch that the consumer turns
// into one Reset span; backlog beyond 1 s faults instead of replaying
// (transport.rs:15-37, 249-462, 475-656); activity epochs gate paused
// streams (transport.rs:668-704, meter.rs:126-142); an idle watchdog
// synthesizes silence when streaming stalls and long silence resets
// processors (transport.rs:32-37,506-528, meter.rs:145-166).
//
// TPU formulation: N independent streams, each with its own SPSC ring and
// timeline, drained by one or more assembler threads that fill a fixed
// [n_streams, block_frames, channels] float32 batch per engine hop plus
// per-stream reset flags — the host half of the device pipeline.  One
// producer thread per stream and one assembler thread per disjoint stream
// range are supported without locks (atomic head/tail indices,
// acquire/release).  The idle watchdog runs on the hop cadence: the
// assembler IS the clock, so "no data this hop" is synthesized silence, and
// max_silence consecutive synthesized frames yield exactly one reset.
//
// Consumption is positional: data_read is always derived from span
// positions rather than incremental deltas, so discarding the backlog after
// a fault can never race a producer into releasing bytes a live span still
// references (the fix for the span_tail/data_tail ordering hazard).
//
// The port's divergence from the JAX package's transport: every stream's
// sample ring lies in one page-aligned arena (stream s at s * data_cap
// floats), which a card can map, and the assembly leaves the samples where
// they are.  One entry, om_assemble_desc, runs the per-stream state machine
// (assemble_rows) into a descriptor sink (DescSink): a descriptor a row, up
// to two ring segments (the wrap), then zeros to the row's end.  A row it
// cannot describe so (silence between PCM, spans of another channel count,
// a third segment) is copied into the caller's staging row, and its
// descriptor points there.  Gathering the descriptors gives the bytes the
// JAX package's copying assembler writes for the same pushes.  The space
// they name is released only by the next pass into the same buffer set that
// asks for it, once the reader of the set is done: each stream keeps its
// consumer read position (data_read: what buffered frames, the backlog cap
// and discards read and move) apart from the released tail that producers
// check for space (data_tail).
// Producers write the rings with streaming stores (write_sanitized), as no
// host core reads a ring while its lines could still be cached.  Each
// stream's fields are grouped by writer (Stream), and the assembler
// prefetches the stream after next.
//
// C ABI only (consumed via ctypes).  No allocation on the producer path
// after setup.

#include <sys/mman.h>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

constexpr double kNsPerSec = 1e9;
constexpr uint32_t kSlots = 4;  // buffer sets a caller may name

enum class SpanKind : uint8_t { Pcm = 0, Silence = 1 };

struct SpanRec {
  SpanKind kind;
  uint32_t frames;
  uint32_t channels;  // stream channel count when this span was pushed
  uint64_t start_ns;
  uint64_t data_pos;  // ring offset of first sample (Pcm only)
  uint64_t generation;
};

struct Stream {
  // Fields are grouped by writer, each group on cache lines of its own, so
  // that the assembler's writes every hop and a producer's on every push
  // do not take each other's lines.

  // --- set up once, or changed rarely ---
  // per-stream format (renegotiable: stream.rs:24-264 set_format).
  // Written only by the stream's producer thread (om_set_channels); spans
  // record the value at push time so the assembler's ring arithmetic stays
  // consistent for in-flight old-format spans.
  std::atomic<uint32_t> channels{2};
  double sample_rate = 48000.0;
  // sample ring (SPSC: producer writes, assembler reads) and span ring
  float* data = nullptr;       // capacity samples (frames * channels), in the arena
  uint64_t arena_off = 0;      // data - arena, in samples
  uint64_t data_cap = 0;       // in samples
  std::vector<SpanRec> spans;
  uint64_t span_cap = 0;
  std::atomic<uint64_t> fault_epoch{0};
  std::atomic<uint64_t> generation{1};
  std::atomic<uint64_t> activity_epoch{0};  // bumped on resume
  std::atomic<uint64_t> resume_span_head{0};  // spans before this are stale
  std::atomic<uint32_t> active{1};

  // --- the producer's, written on every push ---
  alignas(64) std::atomic<uint64_t> data_head{0};  // write position (samples)
  std::atomic<uint64_t> span_head{0};
  uint64_t next_ns = 0;  // timeline
  bool timeline_started = false;

  // --- the assembler's, written every hop ---
  alignas(64) std::atomic<uint64_t> data_read{0};  // read position (samples)
  std::atomic<uint64_t> data_tail{0};  // released: producers may write below tail + cap
  std::atomic<uint64_t> span_tail{0};
  uint64_t carry_frames = 0;  // frames left in the partially consumed span
  bool has_carry = false;
  bool idle_reset_done = false;
  uint64_t idle_frames = 0;  // idle watchdog: consecutive synthesized underrun frames
  uint64_t held[kSlots] = {0, 0, 0, 0};  // data_read at the last descriptor pass into each slot
  // the assembler's, on a new span
  SpanRec carry_span{};
  uint64_t seen_fault_epoch = 0;
  uint64_t seen_generation = 0;
  uint64_t seen_activity_epoch = 0;
};

struct Transport {
  uint32_t n_streams;
  uint32_t channels;       // padded batch channel count
  uint32_t block_frames;   // engine hop (B)
  uint64_t max_backlog_frames;
  uint64_t max_silence_frames;
  float* arena = nullptr;  // every stream's sample ring, page-aligned
  size_t arena_bytes = 0;
  // unique_ptr storage: Stream holds atomics and must never move
  std::vector<std::unique_ptr<Stream>> streams;

  ~Transport() {
    if (arena) munmap(arena, arena_bytes);
  }
};

inline uint64_t ns_to_frames(uint64_t ns, double rate) {
  return (uint64_t)((double)ns * rate / kNsPerSec + 0.5);
}
inline uint64_t frames_to_ns(uint64_t frames, double rate) {
  return (uint64_t)((double)frames * kNsPerSec / rate + 0.5);
}

void fault(Stream& s) { s.fault_epoch.fetch_add(1, std::memory_order_acq_rel); }

// The descriptor pass's two rare paths stay calls: inlined into its one
// caller, g++ 12 at -O3 grows om_assemble_desc by a quarter (546 to 680
// instructions) and the pass's hot loop with it.
__attribute__((noinline)) void discard_until(Stream& s, uint64_t upto_span);
__attribute__((noinline)) void copy_pcm(float* row, uint32_t C, const Stream& s,
                                        uint32_t filled, uint64_t pos,
                                        uint32_t take, uint32_t sch);

// End position (in ring samples) of a span's payload.
inline uint64_t span_data_end(const SpanRec& r, uint32_t ch) {
  return r.kind == SpanKind::Pcm ? r.data_pos + (uint64_t)r.frames * ch : 0;
}

// Drop everything buffered for a stream (assembler side, after a fault).
//
// Race-free by construction: we only ever move data_read to the end of a
// span we have *observed published* (span_head acquire) — any span the
// producer publishes after our snapshot has data_pos >= that end, so its
// payload is never released here.  data_read can never pass data_head
// because every observed span's payload was written before its publication.
void discard_all(Stream& s) {
  uint64_t span_head = s.span_head.load(std::memory_order_acquire);
  uint64_t span_tail = s.span_tail.load(std::memory_order_relaxed);
  uint64_t end = s.data_read.load(std::memory_order_relaxed);
  if (s.has_carry) {
    uint64_t e = span_data_end(s.carry_span, s.carry_span.channels);
    if (e > end) end = e;
  }
  for (uint64_t i = span_tail; i != span_head; ++i) {
    const SpanRec& rec = s.spans[i % s.span_cap];
    uint64_t e = span_data_end(rec, rec.channels);
    if (e > end) end = e;
  }
  s.data_read.store(end, std::memory_order_release);
  s.span_tail.store(span_head, std::memory_order_release);
  s.has_carry = false;
  s.carry_frames = 0;
}

// Discard only spans published before `upto_span` (resume semantics: the
// pre-pause backlog is stale, data pushed after the resume is fresh and
// must survive).  Same positional-release reasoning as discard_all.
void discard_until(Stream& s, uint64_t upto_span) {
  uint64_t span_tail = s.span_tail.load(std::memory_order_relaxed);
  uint64_t span_head = s.span_head.load(std::memory_order_acquire);
  if (upto_span > span_head) upto_span = span_head;
  uint64_t end = s.data_read.load(std::memory_order_relaxed);
  if (s.has_carry) {  // carry predates any post-resume span
    uint64_t e = span_data_end(s.carry_span, s.carry_span.channels);
    if (e > end) end = e;
    s.has_carry = false;
    s.carry_frames = 0;
  }
  for (uint64_t i = span_tail; i < upto_span; ++i) {
    const SpanRec& rec = s.spans[i % s.span_cap];
    uint64_t e = span_data_end(rec, rec.channels);
    if (e > end) end = e;
  }
  s.data_read.store(end, std::memory_order_release);
  if (upto_span > span_tail)
    s.span_tail.store(upto_span, std::memory_order_release);
}

// The finite test of transport.rs:249-261: a branchless exponent-mask
// compare; non-finite samples are written as 0.
inline float sanitized(const float* src) {
  uint32_t bits;
  std::memcpy(&bits, src, 4);
  return (bits & 0x7f800000u) == 0x7f800000u ? 0.0f : *src;
}

// Producers write the rings with streaming stores where the CPU has AVX2:
// no host core reads a ring while its lines could still be cached (a card
// gathers the rows over the host link; a gather on the host reads them
// long after), so the 32-byte stores skip the read for ownership and leave
// the caches alone (12 GB/s from two producer threads on the served cells'
// host, against 8.2 GB/s for a plain memcpy).  The caller fences before it
// publishes the samples.  Other CPUs write plain stores.
#if defined(__x86_64__)
__attribute__((target("avx2"))) void write_sanitized_avx2(float* d, const float* src,
                                                         uint64_t n) {
  uint64_t i = 0;
  for (; i < n && (reinterpret_cast<uintptr_t>(d + i) & 31); ++i) d[i] = sanitized(src + i);
  const __m256i exp_mask = _mm256_set1_epi32(0x7f800000);
  for (; i + 8 <= n; i += 8) {
    __m256 v = _mm256_loadu_ps(src + i);
    __m256i bad = _mm256_cmpeq_epi32(_mm256_and_si256(_mm256_castps_si256(v), exp_mask), exp_mask);
    _mm256_stream_ps(d + i, _mm256_andnot_ps(_mm256_castsi256_ps(bad), v));
  }
  for (; i < n; ++i) d[i] = sanitized(src + i);
}

const bool kAvx2 = (__builtin_cpu_init(), __builtin_cpu_supports("avx2"));
#endif

inline void write_sanitized(float* d, const float* src, uint64_t n) {
#if defined(__x86_64__)
  if (kAvx2) return write_sanitized_avx2(d, src, n);
#endif
  for (uint64_t i = 0; i < n; ++i) d[i] = sanitized(src + i);
}

// Copy `count` samples into the ring at `head`, split at the wrap point.
inline void ring_write_sanitized(Stream& s, uint64_t head, const float* src,
                                 uint64_t count) {
  uint64_t off = head % s.data_cap;
  uint64_t first = count < s.data_cap - off ? count : s.data_cap - off;
  write_sanitized(s.data + off, src, first);
  write_sanitized(s.data, src + first, count - first);
#if defined(__x86_64__)
  _mm_sfence();  // the streaming stores land before data_head publishes them
#endif
}

// Copy `take` frames of a Pcm span from ring position `pos` into frames
// [filled, filled + take) of a [B, C] row.
void copy_pcm(float* row, uint32_t C, const Stream& s, uint32_t filled,
              uint64_t pos, uint32_t take, uint32_t sch) {
  if (sch == C) {
    // contiguous fast path: at most two memcpy segments at the wrap
    uint64_t count = (uint64_t)take * C;
    uint64_t off = pos % s.data_cap;
    uint64_t first = count < s.data_cap - off ? count : s.data_cap - off;
    std::memcpy(row + (size_t)filled * C, s.data + off, sizeof(float) * first);
    if (count > first)
      std::memcpy(row + (size_t)filled * C + first, s.data,
                  sizeof(float) * (count - first));
    return;
  }
  // padded channels [sch, C) must read zero; channels beyond the
  // batch width are dropped (negotiation clamps before this point)
  std::memset(row + (size_t)filled * C, 0, sizeof(float) * take * C);
  const uint32_t copy_ch = sch < C ? sch : C;
  for (uint32_t f = 0; f < take; ++f) {
    uint64_t at = (pos + (uint64_t)f * sch) % s.data_cap;
    if (at + copy_ch <= s.data_cap) {
      std::memcpy(row + (size_t)(filled + f) * C, s.data + at,
                  sizeof(float) * copy_ch);
    } else {
      for (uint32_t c = 0; c < copy_ch; ++c)
        row[(size_t)(filled + f) * C + c] = s.data[(at + c) % s.data_cap];
    }
  }
}

// The descriptor sink: per row, int64 {off0, n0, off1, n1} (arena offsets
// and lengths in samples; zeros past n0 + n1), or {0, -1, 0, 0} for a row
// copied into its `staging` row.  counts: rows of one segment, of two, staged,
// of none.  The ring space a pass reads stays held for `slot` until a later
// pass into `slot` with `release` set gives it back, as it reaches each
// stream and before it reads the stream's rings.
struct DescSink {
  float* staging;
  int64_t* desc;
  uint32_t B, C;
  uint32_t slot;
  bool release;
  const float* arena;
  uint64_t counts[4] = {0, 0, 0, 0};
  float* row = nullptr;
  int nseg = 0;
  uint64_t off[2] = {0, 0}, len[2] = {0, 0};
  bool gap = false;     // silence recorded after the segments
  bool staged = false;  // the row is being copied into its staging row

  void begin(Stream& s, uint32_t si) {
    if (release && s.held[slot] > s.data_tail.load(std::memory_order_relaxed))
      s.data_tail.store(s.held[slot], std::memory_order_release);
    row = staging + (size_t)si * B * C;
    nseg = 0;
    gap = staged = false;
  }
  // Append [o, o + n) to the row's segments, extending the last one where
  // it is contiguous; false where that would need a third.
  bool add(uint64_t o, uint64_t n) {
    if (nseg > 0 && off[nseg - 1] + len[nseg - 1] == o) {
      len[nseg - 1] += n;
      return true;
    }
    if (nseg == 2) return false;
    off[nseg] = o;
    len[nseg] = n;
    ++nseg;
    return true;
  }
  // Copy what the segments hold into the staging row, then zeros up to
  // frame `filled` (a silence span recorded after them).
  void stage(uint32_t filled) {
    uint64_t at = 0;
    for (int k = 0; k < nseg; ++k) {
      std::memcpy(row + at, arena + off[k], sizeof(float) * len[k]);
      at += len[k];
    }
    std::memset(row + at, 0, sizeof(float) * ((uint64_t)filled * C - at));
    staged = true;
  }
  void pcm(const Stream& s, uint32_t filled, uint64_t pos, uint32_t take,
           uint32_t sch) {
    if (!staged) {
      if (sch == C && !gap) {
        const int n0 = nseg;
        const uint64_t l0 = len[0], l1 = len[1];
        uint64_t count = (uint64_t)take * C;
        uint64_t o = pos % s.data_cap;
        uint64_t first = count < s.data_cap - o ? count : s.data_cap - o;
        if (add(s.arena_off + o, first) &&
            (count == first || add(s.arena_off, count - first)))
          return;
        nseg = n0;  // undo a half-added span before staging the row
        len[0] = l0;
        len[1] = l1;
      }
      stage(filled);
    }
    copy_pcm(row, C, s, filled, pos, take, sch);
  }
  void silence(uint32_t filled, uint32_t take) {
    if (staged)
      std::memset(row + (size_t)filled * C, 0, sizeof(float) * take * C);
    else
      gap = true;
  }
  void end(Stream& s, uint32_t si, uint32_t filled) {
    int64_t* d = desc + (size_t)si * 4;
    if (staged) {
      if (filled < B)
        std::memset(row + (size_t)filled * C, 0, sizeof(float) * (B - filled) * C);
      d[0] = 0;
      d[1] = -1;
      d[2] = 0;
      d[3] = 0;
      ++counts[2];
    } else {
      d[0] = nseg > 0 ? (int64_t)off[0] : 0;
      d[1] = nseg > 0 ? (int64_t)len[0] : 0;
      d[2] = nseg > 1 ? (int64_t)off[1] : 0;
      d[3] = nseg > 1 ? (int64_t)len[1] : 0;
      ++counts[nseg == 0 ? 3 : nseg - 1];
    }
    s.held[slot] = s.data_read.load(std::memory_order_relaxed);
  }
};

// The assembler's per-stream state machine over streams [begin, end), each
// row handed to `sink` piece by piece (begin, pcm / silence in row order,
// end once its masks and read position are final).
//
// Per stream, drains buffered spans into exactly block_frames frames:
// - Pcm spans deliver samples (partially consumed spans carry over)
// - Silence spans fill zeros; silence longer than max_silence resets
// - fault-epoch / activity-epoch changes emit reset_mask=1 and drop backlog
// - a generation change mid-block stops filling at the boundary so no
//   old-format PCM is ever delivered after its reset (the reset lands on
//   the next hop, exactly at the format boundary)
// - backlog greater than max_backlog faults (reset, no replay)
// - streams with no data underrun with synthesized silence (underrun_mask=1)
//   and after max_silence consecutive synthesized frames reset once
//   (idle watchdog on the hop cadence)
//
// Returns the number of streams in the range that produced real PCM.
template <class Sink>
int32_t assemble_rows(Transport* t, Sink& sink, uint8_t* reset_mask,
                      uint8_t* underrun_mask, uint32_t begin, uint32_t end) {
  const uint32_t B = t->block_frames;
  if (end > t->n_streams) end = t->n_streams;
  int32_t live = 0;

  for (uint32_t si = begin; si < end; ++si) {
    Stream& s = *t->streams[si];
    if (si + 2 < end) {  // the lines the stream after next reads and writes first
      const Stream& n = *t->streams[si + 2];
      __builtin_prefetch(&n.fault_epoch, 0);
      __builtin_prefetch(&n.data_head, 0);
      __builtin_prefetch(&n.data_read, 1);
    }
    sink.begin(s, si);
    reset_mask[si] = 0;
    underrun_mask[si] = 0;

    // fault epoch -> one Reset (synchronize_fault, transport.rs:561-571)
    uint64_t epoch = s.fault_epoch.load(std::memory_order_acquire);
    if (epoch != s.seen_fault_epoch) {
      s.seen_fault_epoch = epoch;
      discard_all(s);
      reset_mask[si] = 1;
    }
    // resume after pause -> discard the pre-resume backlog, one Reset;
    // data pushed after the resume marker is fresh and delivered this hop
    uint64_t act = s.activity_epoch.load(std::memory_order_acquire);
    if (act != s.seen_activity_epoch) {
      s.seen_activity_epoch = act;
      discard_until(s, s.resume_span_head.load(std::memory_order_acquire));
      reset_mask[si] = 1;
    }

    // backlog cap: more than max_backlog buffered -> reset instead of replay
    {
      uint64_t head = s.data_head.load(std::memory_order_acquire);
      uint64_t read = s.data_read.load(std::memory_order_relaxed);
      uint32_t ch_now = s.channels.load(std::memory_order_acquire);
      if ((head - read) / ch_now > t->max_backlog_frames) {
        discard_all(s);
        reset_mask[si] = 1;
      }
    }

    uint32_t filled = 0;
    bool got_pcm = false;
    bool boundary_split = false;
    while (filled < B) {
      if (!s.has_carry) {
        uint64_t span_tail = s.span_tail.load(std::memory_order_relaxed);
        uint64_t span_head = s.span_head.load(std::memory_order_acquire);
        if (span_tail == span_head) break;  // nothing buffered
        s.carry_span = s.spans[span_tail % s.span_cap];
        s.span_tail.store(span_tail + 1, std::memory_order_release);
        s.carry_frames = s.carry_span.frames;
        s.has_carry = true;
      }

      // generation change resets processors (registry.rs:400-406) — but
      // only on a clean block boundary: if this hop already holds PCM of
      // the previous generation, stop here and deliver the reset next hop.
      if (s.carry_span.generation != s.seen_generation) {
        if (filled > 0) {
          boundary_split = true;
          break;
        }
        s.seen_generation = s.carry_span.generation;
        reset_mask[si] = 1;
      }
      // long silence resets instead of replaying (meter.rs:145-166)
      if (s.carry_span.kind == SpanKind::Silence &&
          s.carry_frames > t->max_silence_frames) {
        s.has_carry = false;
        s.carry_frames = 0;
        reset_mask[si] = 1;
        continue;
      }

      uint32_t take = (uint32_t)std::min<uint64_t>(s.carry_frames, B - filled);
      if (s.carry_span.kind == SpanKind::Pcm) {
        // span-recorded channel count: renegotiations never reinterpret
        // in-flight payload bytes (the round-2 OOB read)
        const uint32_t sch = s.carry_span.channels;
        uint64_t pos = s.carry_span.data_pos +
                       (uint64_t)(s.carry_span.frames - s.carry_frames) * sch;
        sink.pcm(s, filled, pos, take, sch);
        // positional consumption: read = exactly what this span has consumed
        s.data_read.store(pos + (uint64_t)take * sch, std::memory_order_release);
        got_pcm = true;
      } else {
        sink.silence(filled, take);
      }
      filled += take;
      s.carry_frames -= take;
      if (s.carry_frames == 0) s.has_carry = false;
    }

    if (got_pcm || (filled == B) || boundary_split) {
      s.idle_frames = 0;
      s.idle_reset_done = false;
    }
    if (filled < B && !boundary_split) {
      underrun_mask[si] = 1;  // idle watchdog: synthesized silence fill
      s.idle_frames += B - filled;
      if (s.idle_frames > t->max_silence_frames && !s.idle_reset_done) {
        s.idle_reset_done = true;  // reset exactly once, then stay dormant
        discard_all(s);
        reset_mask[si] = 1;
      }
    }
    sink.end(s, si, filled);
    if (got_pcm) ++live;
  }
  return live;
}

}  // namespace

extern "C" {

// Returns null where the ring arena cannot be mapped.
void* om_transport_create(uint32_t n_streams, uint32_t channels,
                          uint32_t block_frames, double default_rate,
                          double ring_seconds, double max_backlog_seconds,
                          double max_silence_seconds) {
  auto t = std::make_unique<Transport>();
  t->n_streams = n_streams;
  t->channels = channels;
  t->block_frames = block_frames;
  t->max_backlog_frames = (uint64_t)(max_backlog_seconds * default_rate);
  t->max_silence_frames = (uint64_t)(max_silence_seconds * default_rate);
  uint64_t cap_frames = (uint64_t)(ring_seconds * default_rate);
  const uint64_t data_cap = cap_frames * channels;
  // one anonymous mapping: page-aligned, and zero pages until first written
  t->arena_bytes = std::max<size_t>(sizeof(float) * n_streams * data_cap, 1);
  void* arena = mmap(nullptr, t->arena_bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (arena == MAP_FAILED) return nullptr;
  t->arena = static_cast<float*>(arena);
  t->streams.reserve(n_streams);
  for (uint32_t i = 0; i < n_streams; ++i) {
    auto s = std::make_unique<Stream>();
    s->channels = channels;
    s->sample_rate = default_rate;
    s->data_cap = data_cap;
    s->arena_off = (uint64_t)i * data_cap;
    s->data = t->arena + s->arena_off;
    s->span_cap = 4096;
    s->spans.resize(s->span_cap);
    t->streams.push_back(std::move(s));
  }
  return t.release();
}

void om_transport_destroy(void* h) { delete static_cast<Transport*>(h); }

// The ring arena: its base and its size in bytes (n_streams * ring
// capacity samples, rounded up to at least one byte).
void* om_arena(void* h) { return static_cast<Transport*>(h)->arena; }
uint64_t om_arena_bytes(void* h) { return static_cast<Transport*>(h)->arena_bytes; }

// Producer: push PCM with a nanosecond timestamp.  Gap > 1 frame becomes a
// Silence span; regression/overlap or ring overflow bumps the fault epoch
// (transport.rs:329-462 semantics).  NaN/Inf samples are sanitized to 0
// (transport.rs:249-261).  Inactive streams drop input (returns 1) —
// pause gates at the producer (meter.rs:126-142).  The space check reads
// the released tail: space a descriptor still names is not free.
int32_t om_push_pcm(void* h, uint32_t stream, const float* samples,
                    uint32_t frames, uint64_t timestamp_ns) {
  auto* t = static_cast<Transport*>(h);
  if (stream >= t->n_streams || frames == 0) return -1;
  Stream& s = *t->streams[stream];
  if (!s.active.load(std::memory_order_acquire)) {
    s.timeline_started = false;
    return 1;
  }
  // producer thread owns this field (om_set_channels is producer-side)
  const uint32_t ch = s.channels.load(std::memory_order_relaxed);
  const uint64_t need = (uint64_t)frames * ch;

  uint64_t start_ns = timestamp_ns;
  if (s.timeline_started) {
    if (timestamp_ns + frames_to_ns(1, s.sample_rate) < s.next_ns) {
      // time went backwards: discontinuity -> fault (transport.rs:432-446)
      fault(s);
      s.timeline_started = false;
    } else if (timestamp_ns > s.next_ns + frames_to_ns(1, s.sample_rate)) {
      // gap -> Silence span.  Clamped so the uint32 frames field can never
      // wrap (a 2^32-multiple gap would otherwise record 0 frames and skip
      // the max_silence reset); anything above max_silence resets anyway.
      uint64_t gap_frames = ns_to_frames(timestamp_ns - s.next_ns, s.sample_rate);
      uint64_t clamp = t->max_silence_frames + 1;
      if (clamp > 0xffffffffull) clamp = 0xffffffffull;
      if (gap_frames > clamp) gap_frames = clamp;
      uint64_t span_head = s.span_head.load(std::memory_order_relaxed);
      uint64_t span_tail = s.span_tail.load(std::memory_order_acquire);
      if (span_head - span_tail >= s.span_cap) {
        fault(s);
        return -2;
      }
      SpanRec& rec = s.spans[span_head % s.span_cap];
      rec.kind = SpanKind::Silence;
      rec.frames = (uint32_t)gap_frames;
      rec.channels = ch;
      rec.start_ns = s.next_ns;
      rec.data_pos = 0;
      rec.generation = s.generation.load(std::memory_order_acquire);
      s.span_head.store(span_head + 1, std::memory_order_release);
    }
  }
  s.timeline_started = true;
  s.next_ns = start_ns + frames_to_ns(frames, s.sample_rate);

  uint64_t head = s.data_head.load(std::memory_order_relaxed);
  uint64_t tail = s.data_tail.load(std::memory_order_acquire);
  if (head + need - tail > s.data_cap) {
    fault(s);  // overflow: no replay, consumer resets (transport.rs:418-430)
    return -2;
  }
  uint64_t span_head = s.span_head.load(std::memory_order_relaxed);
  uint64_t span_tail = s.span_tail.load(std::memory_order_acquire);
  if (span_head - span_tail >= s.span_cap) {
    fault(s);
    return -2;
  }

  ring_write_sanitized(s, head, samples, need);
  s.data_head.store(head + need, std::memory_order_release);

  SpanRec& rec = s.spans[span_head % s.span_cap];
  rec.kind = SpanKind::Pcm;
  rec.frames = frames;
  rec.channels = ch;
  rec.start_ns = start_ns;
  rec.data_pos = head;
  rec.generation = s.generation.load(std::memory_order_acquire);
  s.span_head.store(span_head + 1, std::memory_order_release);
  return 0;
}

// Producer: explicit silence (e.g. stream paused but alive).
int32_t om_push_silence(void* h, uint32_t stream, uint32_t frames,
                        uint64_t timestamp_ns) {
  auto* t = static_cast<Transport*>(h);
  if (stream >= t->n_streams) return -1;
  Stream& s = *t->streams[stream];
  if (!s.active.load(std::memory_order_acquire)) {
    s.timeline_started = false;
    return 1;
  }
  uint64_t span_head = s.span_head.load(std::memory_order_relaxed);
  uint64_t span_tail = s.span_tail.load(std::memory_order_acquire);
  if (span_head - span_tail >= s.span_cap) {
    fault(s);
    return -2;
  }
  SpanRec& rec = s.spans[span_head % s.span_cap];
  rec.kind = SpanKind::Silence;
  rec.frames = frames;
  rec.channels = s.channels.load(std::memory_order_relaxed);
  rec.start_ns = timestamp_ns;
  rec.data_pos = 0;
  rec.generation = s.generation.load(std::memory_order_acquire);
  s.span_head.store(span_head + 1, std::memory_order_release);
  s.timeline_started = true;
  s.next_ns = timestamp_ns + frames_to_ns(frames, s.sample_rate);
  return 0;
}

// Producer: fault injection / stream error (stream.rs Fault classification).
void om_push_fault(void* h, uint32_t stream) {
  auto* t = static_cast<Transport*>(h);
  if (stream < t->n_streams) fault(*t->streams[stream]);
}

// Producer-thread-only: renegotiate the stream's channel layout
// (stream.rs:24-264 set_format).  Must be called from the same thread that
// pushes this stream's PCM; in-flight spans keep the channel count they were
// pushed with, and the caller bumps the generation so the assembler resets
// at the format boundary.
void om_set_channels(void* h, uint32_t stream, uint32_t channels) {
  auto* t = static_cast<Transport*>(h);
  if (stream >= t->n_streams) return;
  if (channels < 1) channels = 1;
  if (channels > 64) channels = 64;
  t->streams[stream]->channels.store(channels, std::memory_order_release);
}

uint32_t om_stream_channels(void* h, uint32_t stream) {
  auto* t = static_cast<Transport*>(h);
  return stream < t->n_streams
             ? t->streams[stream]->channels.load(std::memory_order_acquire)
             : 0;
}

// Producer: format change bumps the generation (AudioFormat::generation).
void om_set_generation(void* h, uint32_t stream, uint64_t generation) {
  auto* t = static_cast<Transport*>(h);
  if (stream < t->n_streams)
    t->streams[stream]->generation.store(generation, std::memory_order_release);
}

// Pause/resume a stream (activity epochs, transport.rs:668-704).  While
// inactive the producer path drops input; resuming bumps the activity epoch
// so the assembler discards anything stale and emits one reset.
void om_set_active(void* h, uint32_t stream, uint32_t active) {
  auto* t = static_cast<Transport*>(h);
  if (stream >= t->n_streams) return;
  Stream& s = *t->streams[stream];
  uint32_t was = s.active.exchange(active ? 1u : 0u, std::memory_order_acq_rel);
  if (!was && active) {
    // marker first, then the epoch bump (assembler acquires epoch, so a
    // new epoch value implies the marker is visible)
    s.resume_span_head.store(s.span_head.load(std::memory_order_acquire),
                             std::memory_order_release);
    s.activity_epoch.fetch_add(1, std::memory_order_acq_rel);
  }
}

uint32_t om_is_active(void* h, uint32_t stream) {
  auto* t = static_cast<Transport*>(h);
  return stream < t->n_streams
             ? t->streams[stream]->active.load(std::memory_order_acquire)
             : 0;
}

uint64_t om_fault_count(void* h, uint32_t stream) {
  auto* t = static_cast<Transport*>(h);
  return stream < t->n_streams
             ? t->streams[stream]->fault_epoch.load(std::memory_order_acquire)
             : 0;
}

// Assembler: one hop of streams [begin, end) (assemble_rows has the
// semantics), writing desc [n_streams, 4] int64 (see DescSink) and,
// for rows it cannot describe, their samples into staging [n_streams,
// block_frames, channels].  counts[4] receives this range's rows of one
// segment, of two, staged and of none.  The ring space read stays held for
// buffer set `slot` (< 4); with `release`, the pass first gives back, stream
// by stream, what the passes into `slot` since the last release read: the
// caller sets it on its first pass into a set once the reader of the set's
// last rows is done.  Returns the number of streams in the range that
// produced real PCM, or -1 for a slot out of range.  Disjoint ranges may run
// on different threads concurrently (each Stream has a single consumer).
int32_t om_assemble_desc(void* h, float* staging, uint8_t* reset_mask,
                         uint8_t* underrun_mask, int64_t* desc,
                         uint64_t* counts, uint32_t begin, uint32_t end,
                         uint32_t slot, uint32_t release) {
  auto* t = static_cast<Transport*>(h);
  if (slot >= kSlots) return -1;
  DescSink sink{staging, desc, t->block_frames, t->channels, slot, release != 0, t->arena};
  int32_t live = assemble_rows(t, sink, reset_mask, underrun_mask, begin, end);
  std::memcpy(counts, sink.counts, sizeof(sink.counts));
  return live;
}

// Frames currently buffered for a stream (diagnostics + backlog coalescing:
// the serving loop runs extra catch-up hops while this exceeds block_frames,
// mirroring DspBatcher's 1024-frame coalescing, meter.rs:15-80).
uint64_t om_buffered_frames(void* h, uint32_t stream) {
  auto* t = static_cast<Transport*>(h);
  if (stream >= t->n_streams) return 0;
  Stream& s = *t->streams[stream];
  uint64_t head = s.data_head.load(std::memory_order_acquire);
  uint64_t read = s.data_read.load(std::memory_order_acquire);
  // a partially-consumed Pcm carry's remaining frames are already included
  // in head - read; only a Silence carry holds frames with no ring data
  uint64_t silence_carry =
      (s.has_carry && s.carry_span.kind == SpanKind::Silence) ? s.carry_frames
                                                              : 0;
  return (head - read) / s.channels.load(std::memory_order_acquire) +
         silence_carry;
}

// Max buffered frames over all streams, in blocks (serving-loop coalescing).
uint32_t om_backlog_blocks(void* h) {
  auto* t = static_cast<Transport*>(h);
  uint64_t max_frames = 0;
  for (uint32_t i = 0; i < t->n_streams; ++i) {
    uint64_t f = om_buffered_frames(h, i);
    if (f > max_frames) max_frames = f;
  }
  return (uint32_t)(max_frames / t->block_frames);
}

}  // extern "C"
