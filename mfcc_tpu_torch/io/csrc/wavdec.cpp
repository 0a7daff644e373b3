// Fast RIFF/WAVE PCM decoder — the native host-side hot loop of the feed
// pipeline (SURVEY.md §6: "the true end-to-end bottleneck is host I/O +
// decode"). Parses the chunk structure, then converts PCM samples to
// float32 with optional channel downmix, all in one pass.
//
// A copy of mfcc_tpu/io/csrc/wavdec.cpp for the port. Exposed as a C ABI
// for ctypes. The Python twin (mfcc_tpu_torch/io/wav.py) implements
// identical semantics in numpy and is the correctness reference; tests
// assert byte-identical float output.
//
// Supported: PCM 8/16/24/32-bit, IEEE float32/float64, WAVE_FORMAT_EXTENSIBLE
// wrappers of those; arbitrary channel counts (mean-downmix or channel 0).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Error codes (keep in sync with wav.py::_DECODE_ERRORS)
enum : int32_t {
  WAV_OK = 0,
  WAV_ERR_TRUNCATED = -1,
  WAV_ERR_NOT_RIFF = -2,
  WAV_ERR_NO_FMT = -3,
  WAV_ERR_BAD_FORMAT = -4,
  WAV_ERR_NO_DATA = -5,
  WAV_ERR_BAD_BITS = -6,
  WAV_ERR_OUT_TOO_SMALL = -7,
  WAV_ERR_IO = -8,
};

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits_per_sample;
  int32_t format;       // 1 = PCM, 3 = IEEE float
  int64_t num_frames;   // samples per channel
  int64_t data_offset;  // byte offset of sample data
  int64_t data_size;    // bytes of sample data
};

static uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // WAV is little-endian; so are our hosts
}
static uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Parse the RIFF structure from a PREFIX of the file: `len` bytes are in
// buf, the file is `file_len` bytes on disk. Chunk sizes and num_frames
// are computed against file_len, so a few-KB header read suffices for
// bucket/row assignment (the feed pipeline's phase A) without pulling the
// whole file through memory twice. Fails WAV_ERR_NO_FMT / NO_DATA when the
// needed chunk headers lie beyond the prefix — caller re-reads fully.
int32_t wav_parse_prefix(const uint8_t* buf, int64_t len, int64_t file_len,
                         WavInfo* info) {
  if (len < 12) return WAV_ERR_TRUNCATED;
  if (std::memcmp(buf, "RIFF", 4) != 0 || std::memcmp(buf + 8, "WAVE", 4) != 0)
    return WAV_ERR_NOT_RIFF;
  int64_t pos = 12;
  bool have_fmt = false;
  std::memset(info, 0, sizeof(*info));
  while (pos + 8 <= len) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_size = rd_u32(hdr + 4);
    int64_t body = pos + 8;
    if (std::memcmp(hdr, "fmt ", 4) == 0) {
      if (body + 16 > len) return WAV_ERR_TRUNCATED;
      uint16_t fmt = rd_u16(buf + body);
      uint16_t channels = rd_u16(buf + body + 2);
      uint32_t rate = rd_u32(buf + body + 4);
      uint16_t bits = rd_u16(buf + body + 14);
      if (fmt == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE: real format in GUID
        if (body + 26 > len) return WAV_ERR_TRUNCATED;
        uint16_t cb = rd_u16(buf + body + 16);
        if (cb >= 22 && body + 18 + 22 <= len)
          fmt = rd_u16(buf + body + 18 + 6);
        else
          return WAV_ERR_BAD_FORMAT;
      }
      if (fmt != 1 && fmt != 3) return WAV_ERR_BAD_FORMAT;
      if (channels == 0) return WAV_ERR_BAD_FORMAT;
      info->format = fmt;
      info->channels = channels;
      info->sample_rate = (int32_t)rate;
      info->bits_per_sample = bits;
      have_fmt = true;
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      info->data_offset = body;
      int64_t avail = file_len - body;
      info->data_size = (int64_t)chunk_size < avail ? (int64_t)chunk_size : avail;
      if (info->data_size < 0) info->data_size = 0;
    }
    pos = body + chunk_size + (chunk_size & 1);  // chunks are word-aligned
  }
  if (!have_fmt) return WAV_ERR_NO_FMT;
  if (info->data_offset == 0) return WAV_ERR_NO_DATA;
  int32_t bytes_per = info->bits_per_sample / 8;
  if (info->format == 1 && !(info->bits_per_sample == 8 || info->bits_per_sample == 16 ||
                             info->bits_per_sample == 24 || info->bits_per_sample == 32))
    return WAV_ERR_BAD_BITS;
  if (info->format == 3 && !(info->bits_per_sample == 32 || info->bits_per_sample == 64))
    return WAV_ERR_BAD_BITS;
  if (bytes_per == 0) return WAV_ERR_BAD_BITS;
  info->num_frames = info->data_size / ((int64_t)bytes_per * info->channels);
  return WAV_OK;
}

// Whole-buffer parse (prefix == full file).
int32_t wav_parse(const uint8_t* buf, int64_t len, WavInfo* info) {
  return wav_parse_prefix(buf, len, len, info);
}

// Decode to float32. Scaling matches the numpy twin:
//   int16  -> raw sample values (the tutorial/scipy convention: no /32768)
//   int8   -> (v - 128) * 256        (centered, int16 range)
//   int24  -> v / 256                (int16 range)
//   int32  -> v / 65536              (int16 range)
//   float  -> v * 32768              (int16 range)
// downmix: 0 = channel 0, 1 = mean over channels.
//
// Decodes min(num_frames, out_cap) samples and ZERO-FILLS out up to
// out_cap — out can be a padded batch row written in place (the feed
// pipeline's decode-into-buffer path); the caller reads info->num_frames
// for the true file length and clamps for the valid count.
int32_t wav_decode_f32(const uint8_t* buf, int64_t len, int32_t downmix,
                       float* out, int64_t out_cap, WavInfo* info) {
  int32_t rc = wav_parse(buf, len, info);
  if (rc != WAV_OK) return rc;
  const uint8_t* d = buf + info->data_offset;
  const int64_t n =
      info->num_frames < out_cap ? info->num_frames : out_cap;
  const int c = info->channels;
  const float inv_c = 1.0f / (float)c;

  auto emit = [&](auto read_one, int stride) {
    if (c == 1) {
      for (int64_t i = 0; i < n; ++i) out[i] = read_one(d + i * stride);
    } else if (downmix == 0) {
      for (int64_t i = 0; i < n; ++i) out[i] = read_one(d + i * stride * c);
    } else {
      for (int64_t i = 0; i < n; ++i) {
        float acc = 0.f;
        const uint8_t* p = d + i * (int64_t)stride * c;
        for (int ch = 0; ch < c; ++ch) acc += read_one(p + ch * stride);
        out[i] = acc * inv_c;
      }
    }
  };

  if (info->format == 1) {
    switch (info->bits_per_sample) {
      case 8:
        emit([](const uint8_t* p) { return ((float)*p - 128.0f) * 256.0f; }, 1);
        break;
      case 16:
        emit([](const uint8_t* p) {
          int16_t v; std::memcpy(&v, p, 2); return (float)v; }, 2);
        break;
      case 24:
        emit([](const uint8_t* p) {
          int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                                ((uint32_t)p[2] << 16));
          if (v & 0x800000) v |= (int32_t)0xFF000000;
          return (float)v / 256.0f; }, 3);
        break;
      case 32:
        emit([](const uint8_t* p) {
          int32_t v; std::memcpy(&v, p, 4); return (float)v / 65536.0f; }, 4);
        break;
      default:
        return WAV_ERR_BAD_BITS;
    }
  } else {  // IEEE float
    if (info->bits_per_sample == 32) {
      emit([](const uint8_t* p) {
        float v; std::memcpy(&v, p, 4); return v * 32768.0f; }, 4);
    } else {
      emit([](const uint8_t* p) {
        double v; std::memcpy(&v, p, 8); return (float)(v * 32768.0); }, 8);
    }
  }
  if (n < out_cap) std::memset(out + n, 0, (out_cap - n) * sizeof(float));
  return WAV_OK;
}

// Decode to int16 — the half-bandwidth feed path (SURVEY.md §7.1 step 7:
// "int16→fp32 conversion on-device to halve feed bytes"). Values are the
// same int16-range convention as wav_decode_f32, rounded to nearest-even
// (lrintf under the default FP rounding mode — matches numpy.rint) and
// clipped: PCM16 passes through EXACTLY (single memcpy for mono), other
// widths quantize at ±0.5 LSB of the int16 scale, i.e. the precision of a
// 16-bit recording.
int32_t wav_decode_i16(const uint8_t* buf, int64_t len, int32_t downmix,
                       int16_t* out, int64_t out_cap, WavInfo* info) {
  int32_t rc = wav_parse(buf, len, info);
  if (rc != WAV_OK) return rc;
  const uint8_t* d = buf + info->data_offset;
  const int64_t n =
      info->num_frames < out_cap ? info->num_frames : out_cap;
  const int c = info->channels;
  const float inv_c = 1.0f / (float)c;

  auto clip16 = [](float v) {
    long r = lrintf(v);
    if (r > 32767) r = 32767;
    if (r < -32768) r = -32768;
    return (int16_t)r;
  };
  auto emit = [&](auto read_one, int stride) {
    if (c == 1) {
      for (int64_t i = 0; i < n; ++i) out[i] = clip16(read_one(d + i * stride));
    } else if (downmix == 0) {
      for (int64_t i = 0; i < n; ++i)
        out[i] = clip16(read_one(d + i * stride * c));
    } else {
      for (int64_t i = 0; i < n; ++i) {
        float acc = 0.f;
        const uint8_t* p = d + i * (int64_t)stride * c;
        for (int ch = 0; ch < c; ++ch) acc += read_one(p + ch * stride);
        out[i] = clip16(acc * inv_c);
      }
    }
  };

  if (info->format == 1 && info->bits_per_sample == 16) {
    if (c == 1) {
      std::memcpy(out, d, (size_t)n * 2);  // the hot path: pure memcpy
    } else if (downmix == 0) {
      for (int64_t i = 0; i < n; ++i)
        std::memcpy(out + i, d + i * 2 * c, 2);
    } else {
      emit([](const uint8_t* p) {
        int16_t v; std::memcpy(&v, p, 2); return (float)v; }, 2);
    }
  } else if (info->format == 1) {
    switch (info->bits_per_sample) {
      case 8:
        emit([](const uint8_t* p) { return ((float)*p - 128.0f) * 256.0f; }, 1);
        break;
      case 24:
        emit([](const uint8_t* p) {
          int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                                ((uint32_t)p[2] << 16));
          if (v & 0x800000) v |= (int32_t)0xFF000000;
          return (float)v / 256.0f; }, 3);
        break;
      case 32:
        emit([](const uint8_t* p) {
          int32_t v; std::memcpy(&v, p, 4); return (float)v / 65536.0f; }, 4);
        break;
      default:
        return WAV_ERR_BAD_BITS;
    }
  } else {  // IEEE float
    if (info->bits_per_sample == 32) {
      emit([](const uint8_t* p) {
        float v; std::memcpy(&v, p, 4); return v * 32768.0f; }, 4);
    } else {
      emit([](const uint8_t* p) {
        double v; std::memcpy(&v, p, 8); return (float)(v * 32768.0); }, 8);
    }
  }
  if (n < out_cap) std::memset(out + n, 0, (out_cap - n) * sizeof(int16_t));
  return WAV_OK;
}

// Phase-A header parse from a path: ONE pread of a small prefix + the
// prefix parser (num_frames computed against the stat size). The feed's
// bucketing/row assignment needs only (sample_rate, num_frames); doing it
// here keeps the consumer thread's per-file cost at a ctypes call instead
// of a Python open + 8 KB read (VERDICT r2 item 8). Exotic chunk layouts
// (fmt/data beyond 4 KB) return WAV_ERR_NO_FMT/NO_DATA and the caller
// falls back to its full-read parse.
int32_t wav_parse_file(const char* path, WavInfo* info) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return WAV_ERR_IO;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return WAV_ERR_IO;
  }
  if (st.st_size <= 0) {
    close(fd);
    return WAV_ERR_TRUNCATED;
  }
  uint8_t hdr[4096];
  ssize_t hr = pread(fd, hdr, sizeof hdr, 0);
  close(fd);
  if (hr < 0) return WAV_ERR_IO;
  return wav_parse_prefix(hdr, hr, st.st_size, info);
}

// One-call file decode: open + read + decode, no Python-side bytes object.
// The file is read into a thread-local buffer reused across calls (grown
// geometrically), so steady-state cost is one open/read/close plus the
// decode — no per-file mmap/munmap (munmap in a thread pool triggers TLB
// shootdown IPIs across all cores and was measured SLOWER threaded than
// serial), no per-file allocation. want_i16 selects the int16 path (out
// must be an int16 buffer) vs float32.
int32_t wav_decode_file(const char* path, int32_t downmix, int32_t want_i16,
                        void* out, int64_t out_cap, WavInfo* info) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return WAV_ERR_IO;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return WAV_ERR_IO;
  }
  if (st.st_size <= 0) {
    close(fd);
    return WAV_ERR_TRUNCATED;
  }
  // Fast path (the feed's dominant case: PCM16 mono file -> int16 row):
  // parse a small header pread, then pread the data chunk STRAIGHT into
  // the caller's row — the page-cache -> row copy is the only copy, the
  // staging-buffer read below is skipped entirely (measured 61 -> 46
  // µs per 8-s utterance, scripts/bench_feed.py r4).
  if (want_i16) {
    uint8_t hdr[4096];
    ssize_t hr = pread(fd, hdr, sizeof hdr, 0);
    WavInfo hi;
    if (hr >= 12 &&
        wav_parse_prefix(hdr, hr, st.st_size, &hi) == WAV_OK &&
        hi.format == 1 && hi.bits_per_sample == 16 && hi.channels == 1) {
      const int64_t n = hi.num_frames < out_cap ? hi.num_frames : out_cap;
      int16_t* o = (int16_t*)out;
      int64_t need = n * 2, got = 0;
      while (got < need) {
        ssize_t r = pread(fd, (uint8_t*)o + got, (size_t)(need - got),
                          hi.data_offset + got);
        if (r < 0) {
          close(fd);
          return WAV_ERR_IO;
        }
        if (r == 0) break;  // file shrank since fstat
        got += r;
      }
      close(fd);
      if (got < need) {
        std::memset((uint8_t*)o + got, 0, (size_t)(need - got));
        hi.num_frames = got / 2;  // report what was actually decodable so
        // the feed worker's changed-file cross-check fires
      }
      if (n < out_cap)
        std::memset(o + n, 0, (size_t)(out_cap - n) * sizeof(int16_t));
      *info = hi;
      return WAV_OK;
    }
    // header beyond the prefix / other formats: generic staging path
  }
  static thread_local uint8_t* buf = nullptr;
  static thread_local int64_t buf_cap = 0;
  if (buf_cap < st.st_size) {
    int64_t want = buf_cap > 0 ? buf_cap : (int64_t)1 << 20;
    while (want < st.st_size) want *= 2;
    uint8_t* nb = (uint8_t*)realloc(buf, (size_t)want);
    if (!nb) {
      close(fd);
      return WAV_ERR_IO;
    }
    buf = nb;
    buf_cap = want;
  }
  int64_t got = 0;
  while (got < st.st_size) {
    ssize_t r = read(fd, buf + got, (size_t)(st.st_size - got));
    if (r < 0) {
      close(fd);
      return WAV_ERR_IO;
    }
    if (r == 0) break;  // file shrank since fstat: decode what we have
    got += r;
  }
  close(fd);
  if (want_i16)
    return wav_decode_i16(buf, got, downmix, (int16_t*)out, out_cap, info);
  return wav_decode_f32(buf, got, downmix, (float*)out, out_cap, info);
}

}  // extern "C"
