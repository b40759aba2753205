// misonet_native — host-side data-path accelerators for misonet_tpu.
//
// The reference's data path is pure Python (librosa decode + numpy chunking
// across 70 DataLoader workers, dataloader/SMS_WSJ.py:18-29, data.py:605-616);
// this library provides the native equivalents the device pipeline feeds from:
//
//   * RIFF/WAVE PCM16/PCM32/float32 decode straight into float32 buffers
//   * single-pass sliding-window chunker (4 s window / 2 s hop with tail
//     zero-pad, matching ops/chunk.py:train_chunks semantics)
//   * batched shard packing: decode + chunk a list of files into one
//     contiguous batch buffer, parallelized with std::thread
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  Python side:
// misonet_tpu/data/native.py (falls back to the pure-Python path when the
// shared library has not been built).
//
// Build: make -C native   (produces libmisonet_native.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int format = 0;  // 1 = PCM int, 3 = IEEE float
  long num_frames = 0;
  long data_offset = 0;
};

bool parse_wav_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4) != 0) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4) != 0) return false;
  // walk chunks
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (memcmp(id, "fmt ", 4) == 0) {
      uint16_t fmt, ch, block, bits;
      uint32_t rate, byterate;
      if (fread(&fmt, 2, 1, f) != 1) return false;
      if (fread(&ch, 2, 1, f) != 1) return false;
      if (fread(&rate, 4, 1, f) != 1) return false;
      if (fread(&byterate, 4, 1, f) != 1) return false;
      if (fread(&block, 2, 1, f) != 1) return false;
      if (fread(&bits, 2, 1, f) != 1) return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = (int)rate;
      info->bits = bits;
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->num_frames =
          (long)sz / (info->channels * (info->bits / 8));
      return info->channels > 0 && info->bits > 0;
    } else {
      fseek(f, (long)sz + (sz & 1), SEEK_CUR);
    }
  }
  return false;
}

// Decode up to max_frames frames into out [frames, channels] float32.
long decode_wav(const char* path, float* out, long max_frames, WavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (!parse_wav_header(f, info)) {
    fclose(f);
    return -2;
  }
  long frames = info->num_frames;
  if (max_frames > 0 && frames > max_frames) frames = max_frames;
  const long n = frames * info->channels;
  fseek(f, info->data_offset, SEEK_SET);
  long got = 0;
  if (info->bits == 16 && info->format == 1) {
    std::vector<int16_t> buf(n);
    got = (long)fread(buf.data(), 2, n, f);
    const float k = 1.0f / 32768.0f;
    for (long i = 0; i < got; ++i) out[i] = buf[i] * k;
  } else if (info->bits == 32 && info->format == 1) {
    std::vector<int32_t> buf(n);
    got = (long)fread(buf.data(), 4, n, f);
    const float k = 1.0f / 2147483648.0f;
    for (long i = 0; i < got; ++i) out[i] = buf[i] * k;
  } else if (info->bits == 32 && info->format == 3) {
    got = (long)fread(out, 4, n, f);
  } else {
    fclose(f);
    return -3;
  }
  fclose(f);
  return got / info->channels;
}

}  // namespace

extern "C" {

// Probe a wav file: returns 0 on success and fills (frames, channels, rate).
int wav_info(const char* path, long* frames, int* channels, int* rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_wav_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  *frames = info.num_frames;
  *channels = info.channels;
  *rate = info.sample_rate;
  return 0;
}

// Decode a wav into out [frames, channels] float32 (caller-allocated).
// Returns frames decoded, negative on error.
long wav_read(const char* path, float* out, long max_frames) {
  WavInfo info;
  return decode_wav(path, out, max_frames, &info);
}

// Number of train chunks a signal of n frames yields (window `chunk`,
// hop `least`, tails in [least, chunk) zero-padded — ops/chunk.py parity).
long chunk_count(long n, long chunk, long least) {
  long count = 0;
  for (long start = 0; n - start >= least; start += least) ++count;
  return count;
}

// Slice in [n, ch] float32 into out [count, chunk, ch] with tail zero-pad.
void chunk_copy(const float* in, long n, int ch, long chunk, long least,
                float* out) {
  long idx = 0;
  for (long start = 0; n - start >= least; start += least, ++idx) {
    long avail = n - start;
    long copy = avail < chunk ? avail : chunk;
    float* dst = out + idx * chunk * ch;
    memcpy(dst, in + start * ch, (size_t)(copy * ch) * sizeof(float));
    if (copy < chunk)
      memset(dst + copy * ch, 0, (size_t)((chunk - copy) * ch) * sizeof(float));
  }
}

// Decode + chunk a batch of wav files in parallel.
// paths: array of C strings; out: [total_chunks, chunk, ch] contiguous;
// chunk_offsets: per-file starting chunk index (caller precomputes via
// wav_info + chunk_count).  Returns 0 on success, else index+1 of the
// first failing file.
int pack_shards(const char** paths, int num_files, const long* chunk_offsets,
                long chunk, long least, int channels, float* out,
                int num_threads) {
  std::vector<int> status(num_files, 0);
  auto work = [&](int tid) {
    for (int i = tid; i < num_files; i += num_threads) {
      WavInfo info;
      long frames;
      int ch, rate;
      if (wav_info(paths[i], &frames, &ch, &rate) != 0 || ch != channels) {
        status[i] = 1;
        continue;
      }
      std::vector<float> buf((size_t)frames * ch);
      long got = decode_wav(paths[i], buf.data(), frames, &info);
      if (got <= 0) {
        status[i] = 1;
        continue;
      }
      chunk_copy(buf.data(), got, ch, chunk, least,
                 out + chunk_offsets[i] * chunk * channels);
    }
  };
  std::vector<std::thread> threads;
  const int nt = num_threads > 0 ? num_threads : 1;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  for (int i = 0; i < num_files; ++i)
    if (status[i]) return i + 1;
  return 0;
}

}  // extern "C"
