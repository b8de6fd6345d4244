// Host-side native code of the port (C ABI, loaded with ctypes; a copy of
// the JAX package's `native/native.cc`): a RIFF/WAVE batch decoder with a
// worker-thread pool, which overlaps file IO with the card's work (the numpy
// reader in data/wavio.py defines the semantics), and a Levenshtein kernel
// for the phone error rate at validation.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread native.cc -o libnative.so
// (done at first use by native/__init__.py; no external dependencies).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Wav {
  int sr = 0;
  int n_ch = 0;
  int bits = 0;
  int fmt = 0;  // 1 = PCM, 3 = IEEE float
  const uint8_t* data = nullptr;
  long data_len = 0;  // bytes
};

// Parse chunks; returns false on malformed files.
bool parse_wav(const uint8_t* buf, long len, Wav* w) {
  if (len < 44 || memcmp(buf, "RIFF", 4) || memcmp(buf + 8, "WAVE", 4)) return false;
  long pos = 12;
  bool have_fmt = false;
  while (pos + 8 <= len) {
    uint32_t size;
    memcpy(&size, buf + pos + 4, 4);
    const uint8_t* body = buf + pos + 8;
    if (!memcmp(buf + pos, "fmt ", 4) && size >= 16) {
      uint16_t fmt, n_ch, bits;
      uint32_t sr;
      memcpy(&fmt, body, 2);
      memcpy(&n_ch, body + 2, 2);
      memcpy(&sr, body + 4, 4);
      memcpy(&bits, body + 14, 2);
      if (fmt == 0xFFFE) fmt = 1;  // WAVE_FORMAT_EXTENSIBLE: assume PCM subformat
      w->fmt = fmt;
      w->n_ch = n_ch;
      w->sr = (int)sr;
      w->bits = bits;
      have_fmt = true;
    } else if (!memcmp(buf + pos, "data", 4)) {
      w->data = body;
      w->data_len = size;
      if (w->data + w->data_len > buf + len) w->data_len = buf + len - w->data;
    }
    pos += 8 + size + (size & 1);
  }
  return have_fmt && w->data != nullptr;
}

// Decode channel `ch` into float32 [-1, 1]; returns samples written or -1.
long decode(const Wav& w, int ch, float* out, long cap) {
  if (ch >= w.n_ch) return -1;
  const int bytes = w.bits / 8;
  const long frames = w.data_len / (bytes * w.n_ch);
  const long n = frames < cap ? frames : cap;
  const uint8_t* p = w.data + ch * bytes;
  const long stride = (long)bytes * w.n_ch;
  if (w.fmt == 3 && w.bits == 32) {
    for (long i = 0; i < n; i++) memcpy(out + i, p + i * stride, 4);
  } else if (w.fmt == 1 && w.bits == 16) {
    for (long i = 0; i < n; i++) {
      int16_t v;
      memcpy(&v, p + i * stride, 2);
      out[i] = (float)v / 32768.0f;
    }
  } else if (w.fmt == 1 && w.bits == 32) {
    for (long i = 0; i < n; i++) {
      int32_t v;
      memcpy(&v, p + i * stride, 4);
      out[i] = (float)v / 2147483648.0f;
    }
  } else if (w.fmt == 1 && w.bits == 24) {
    for (long i = 0; i < n; i++) {
      const uint8_t* b = p + i * stride;
      int32_t v = (int32_t)(b[0] | (b[1] << 8) | ((int8_t)b[2] << 16));
      out[i] = (float)v / 8388608.0f;
    }
  } else {
    return -1;
  }
  return n;
}

long read_one(const char* path, int ch, float* out, long cap, int* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(len);
  if (fread(buf.data(), 1, len, f) != (size_t)len) {
    fclose(f);
    return -1;
  }
  fclose(f);
  Wav w;
  if (!parse_wav(buf.data(), len, &w)) return -1;
  if (sr_out) *sr_out = w.sr;
  return decode(w, ch, out, cap);
}

}  // namespace

extern "C" {

// Single-file decode: returns samples written (or -1). *sr receives rate.
long stt_wav_read(const char* path, float* out, long capacity, int channel, int* sr) {
  return read_one(path, channel, out, capacity, sr);
}

// Batch decode with a thread pool: paths -> out[b * stride .. +lengths[b]].
// lengths[b] = -1 on per-file failure; returns 0, or -1 on bad args.
int stt_wav_read_batch(const char** paths, int n, float* out, long stride,
                       long* lengths, int* srs, int channel, int n_threads) {
  if (n <= 0 || stride <= 0) return -1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      lengths[i] = read_one(paths[i], channel, out + (long)i * stride, stride, srs + i);
    }
  };
  int nt = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return 0;
}

// Levenshtein distance over int token sequences (the phone error rate's
// inner loop).
long stt_edit_distance(const int32_t* a, long la, const int32_t* b, long lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<long> prev(lb + 1), cur(lb + 1);
  for (long j = 0; j <= lb; j++) prev[j] = j;
  for (long i = 1; i <= la; i++) {
    cur[0] = i;
    for (long j = 1; j <= lb; j++) {
      long sub = prev[j - 1] + (a[i - 1] != b[j - 1]);
      long del = prev[j] + 1;
      long ins = cur[j - 1] + 1;
      long m = sub < del ? sub : del;
      cur[j] = m < ins ? m : ins;
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

}  // extern "C"
