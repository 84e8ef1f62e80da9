// Native batch WAV loader for the training data pipeline.
//
// TPU-native counterpart of the reference's torch DataLoader worker processes
// (reference sgmse/data_module.py:57-93, 220-236): instead of Python workers
// decoding one file at a time under the GIL, one C call decodes, crops, pads
// and normalizes a whole (clean, noisy) batch into preallocated float32
// buffers using a C++ thread pool. Semantics mirror Specs.__getitem__
// (data_module.py:61-87): random (train) / center crop to target_len,
// half/half zero-pad when short, max-abs normalization by noisy/clean/none.
//
// Supported WAV encodings: PCM 8/16/24/32-bit and IEEE float32/float64, any
// channel count (first channel is used, matching x[0] in the reference).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread wavload.cc -o libwavload.so
// (compiled on demand by sgmse_tpu/data/native.py, ctypes binding).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // first channel only
  int sample_rate = 0;
};

// splitmix64: deterministic per-item RNG stream from (seed, index).
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline double uniform01(uint64_t& s) {
  return (splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);  // 53-bit
}

static bool read_file(const char* path, std::vector<uint8_t>& out,
                      std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    err = std::string("empty file ") + path;
    return false;
  }
  out.resize(static_cast<size_t>(size));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (got != out.size()) {
    err = std::string("short read ") + path;
    return false;
  }
  return true;
}

static inline uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
static inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

static bool parse_wav(const char* path, WavData& wav, std::string& err) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf, err)) return false;
  if (buf.size() < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    err = std::string("not a RIFF/WAVE file: ") + path;
    return false;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  uint16_t block_align = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    size_t avail = buf.size() - pos - 8;
    uint32_t use_len = chunk_len > avail ? static_cast<uint32_t>(avail) : chunk_len;
    if (std::memcmp(hdr, "fmt ", 4) == 0 && use_len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      sample_rate = rd_u32(body + 4);
      block_align = rd_u16(body + 12);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && use_len >= 26) {  // WAVE_FORMAT_EXTENSIBLE
        fmt = rd_u16(body + 24);
      }
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = use_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!data || channels == 0 || bits == 0) {
    err = std::string("missing fmt/data chunk: ") + path;
    return false;
  }
  const int bytes_per_sample = bits / 8;
  const int stride = block_align ? block_align : bytes_per_sample * channels;
  const size_t n_frames = data_len / stride;
  wav.sample_rate = static_cast<int>(sample_rate);
  wav.samples.resize(n_frames);

  if (fmt == 1) {  // integer PCM
    if (bits == 16) {
      for (size_t i = 0; i < n_frames; ++i) {
        int16_t v;
        std::memcpy(&v, data + i * stride, 2);
        wav.samples[i] = static_cast<float>(v) / 32768.0f;
      }
    } else if (bits == 24) {
      for (size_t i = 0; i < n_frames; ++i) {
        const uint8_t* p = data + i * stride;
        int32_t v = (static_cast<int32_t>(p[0]) << 8) |
                    (static_cast<int32_t>(p[1]) << 16) |
                    (static_cast<int32_t>(p[2]) << 24);
        wav.samples[i] = static_cast<float>(v >> 8) / 8388608.0f;
      }
    } else if (bits == 32) {
      for (size_t i = 0; i < n_frames; ++i) {
        int32_t v;
        std::memcpy(&v, data + i * stride, 4);
        wav.samples[i] = static_cast<float>(v) / 2147483648.0f;
      }
    } else if (bits == 8) {  // unsigned
      for (size_t i = 0; i < n_frames; ++i) {
        wav.samples[i] = (static_cast<float>(data[i * stride]) - 128.0f) / 128.0f;
      }
    } else {
      err = std::string("unsupported PCM bit depth: ") + path;
      return false;
    }
  } else if (fmt == 3) {  // IEEE float
    if (bits == 32) {
      for (size_t i = 0; i < n_frames; ++i) {
        float v;
        std::memcpy(&v, data + i * stride, 4);
        wav.samples[i] = v;
      }
    } else if (bits == 64) {
      for (size_t i = 0; i < n_frames; ++i) {
        double v;
        std::memcpy(&v, data + i * stride, 8);
        wav.samples[i] = static_cast<float>(v);
      }
    } else {
      err = std::string("unsupported float bit depth: ") + path;
      return false;
    }
  } else {
    err = std::string("unsupported WAV format code: ") + path;
    return false;
  }
  return true;
}

// Crop/pad + normalize one pair into out_x/out_y rows (target_len each).
static bool process_pair(const char* clean_path, const char* noisy_path,
                         long target_len, int random_crop, uint64_t item_seed,
                         int normalize_mode, float* out_x, float* out_y,
                         std::string& err) {
  WavData cx, ny;
  if (!parse_wav(clean_path, cx, err)) return false;
  if (!parse_wav(noisy_path, ny, err)) return false;
  const long len = static_cast<long>(std::min(cx.samples.size(),
                                              ny.samples.size()));
  long start = 0, n_copy = target_len, pad_front = 0;
  if (len >= target_len) {
    if (random_crop) {
      uint64_t s = item_seed;
      start = static_cast<long>(uniform01(s) * (len - target_len));
    } else {
      start = (len - target_len) / 2;
    }
  } else {
    const long pad = target_len - len;
    pad_front = pad / 2;  // zero-pad half/half (data_module.py:74-76)
    n_copy = len;
  }
  std::memset(out_x, 0, sizeof(float) * target_len);
  std::memset(out_y, 0, sizeof(float) * target_len);
  std::memcpy(out_x + pad_front, cx.samples.data() + start,
              sizeof(float) * n_copy);
  std::memcpy(out_y + pad_front, ny.samples.data() + start,
              sizeof(float) * n_copy);

  float normfac = 1.0f;
  if (normalize_mode == 1 || normalize_mode == 2) {
    const float* src = normalize_mode == 1 ? out_y : out_x;
    float m = 0.0f;
    for (long i = 0; i < target_len; ++i) m = std::max(m, std::fabs(src[i]));
    normfac = std::max(m, 1e-10f);
  }
  if (normfac != 1.0f) {
    const float inv = 1.0f / normfac;
    for (long i = 0; i < target_len; ++i) {
      out_x[i] *= inv;
      out_y[i] *= inv;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; nonzero with `err` filled on failure.
int sgmse_load_pair_batch(const char** clean_paths, const char** noisy_paths,
                          int n, long target_len, int random_crop,
                          unsigned long long seed, int normalize_mode,
                          float* out_x, float* out_y, char* err, int err_len) {
  const int n_threads =
      std::max(1, std::min<int>(n, std::thread::hardware_concurrency()));
  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  std::string first_err;
  std::vector<std::thread> pool;
  std::vector<std::string> errors(n_threads);

  auto worker = [&](int tid) {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      if (failed.load(std::memory_order_relaxed)) return;
      uint64_t item_seed = seed * 0x9E3779B97F4A7C15ULL + 0xD1B54A32D192ED03ULL +
                           static_cast<uint64_t>(i);
      std::string e;
      if (!process_pair(clean_paths[i], noisy_paths[i], target_len, random_crop,
                        item_seed, normalize_mode, out_x + i * target_len,
                        out_y + i * target_len, e)) {
        errors[tid] = e;
        failed.store(true);
      }
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();

  if (failed.load()) {
    for (const auto& e : errors) {
      if (!e.empty()) { first_err = e; break; }
    }
    std::snprintf(err, err_len, "%s", first_err.c_str());
    return 1;
  }
  return 0;
}

// Decode one WAV fully (for inference-side IO): fills out with up to max_len
// samples of the first channel, stores the true length and sample rate.
int sgmse_read_wav(const char* path, float* out, long max_len, long* out_len,
                   int* out_sr, char* err, int err_len) {
  WavData w;
  std::string e;
  if (!parse_wav(path, w, e)) {
    std::snprintf(err, err_len, "%s", e.c_str());
    return 1;
  }
  const long n = static_cast<long>(w.samples.size());
  *out_len = n;
  *out_sr = w.sample_rate;
  if (out && max_len > 0) {
    std::memcpy(out, w.samples.data(),
                sizeof(float) * std::min(n, max_len));
  }
  return 0;
}

}  // extern "C"
