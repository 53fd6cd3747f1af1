// recordio: chunked, CRC-checked, optionally-compressed record file.
//
// The port's copy of the JAX package's host C++ recordio
// (paddle_tpu/native/recordio.cpp; reference paddle/fluid/recordio/
// {chunk,writer,scanner}.h): records are batched into chunks, each chunk
// carries a header with a magic number, compressor id, record count,
// payload length and CRC32, exposed through a flat C ABI that Python
// binds with ctypes.  The bytes on disk are the JAX package's.
//
// Layout per chunk:
//   u32 magic (0x0dea11ed)  u32 compressor (0=raw, 1=zlib)
//   u32 num_records         u32 payload_len (compressed)
//   u32 raw_len             u32 crc32(payload)
//   payload: concat of (u32 len, bytes) per record, possibly deflated.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>

namespace {

constexpr uint32_t kMagic = 0x0dea11ed;
constexpr uint32_t kRaw = 0;
constexpr uint32_t kZlib = 1;

struct Header {
  uint32_t magic, compressor, num_records, payload_len, raw_len, crc;
};

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

std::vector<uint8_t> deflate_buf(const std::vector<uint8_t>& in) {
  uLongf out_len = compressBound(in.size());
  std::vector<uint8_t> out(out_len);
  if (compress2(out.data(), &out_len, in.data(), in.size(), 6) != Z_OK)
    return {};
  out.resize(out_len);
  return out;
}

bool inflate_buf(const uint8_t* in, size_t in_len, std::vector<uint8_t>* out,
                 size_t raw_len) {
  out->resize(raw_len);
  uLongf dst = raw_len;
  if (uncompress(out->data(), &dst, in, in_len) != Z_OK) return false;
  out->resize(dst);
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Writer
// ---------------------------------------------------------------------------

struct RecWriter {
  FILE* f = nullptr;
  uint32_t compressor = kZlib;
  uint32_t max_records = 1000;
  std::vector<uint8_t> buf;
  uint32_t n_records = 0;

  bool flush_chunk() {
    if (n_records == 0) return true;
    std::vector<uint8_t> payload;
    uint32_t comp = compressor;
    if (compressor == kZlib) {
      payload = deflate_buf(buf);
      if (payload.empty() && !buf.empty()) return false;
    } else {
      payload = buf;
    }
    Header h{kMagic, comp, n_records, (uint32_t)payload.size(),
             (uint32_t)buf.size(),
             (uint32_t)crc32(0, payload.data(), payload.size())};
    if (!write_all(f, &h, sizeof(h))) return false;
    if (!write_all(f, payload.data(), payload.size())) return false;
    buf.clear();
    n_records = 0;
    return true;
  }
};

extern "C" {

RecWriter* recio_writer_open(const char* path, uint32_t compressor,
                             uint32_t max_records_per_chunk) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new RecWriter();
  w->f = f;
  w->compressor = compressor;
  if (max_records_per_chunk) w->max_records = max_records_per_chunk;
  return w;
}

int recio_writer_write(RecWriter* w, const uint8_t* data, uint32_t len) {
  uint32_t n = len;
  const uint8_t* np = reinterpret_cast<const uint8_t*>(&n);
  w->buf.insert(w->buf.end(), np, np + 4);
  w->buf.insert(w->buf.end(), data, data + len);
  w->n_records++;
  if (w->n_records >= w->max_records) return w->flush_chunk() ? 0 : -1;
  return 0;
}

int recio_writer_close(RecWriter* w) {
  int rc = w->flush_chunk() ? 0 : -1;
  fclose(w->f);
  delete w;
  return rc;
}

// ---------------------------------------------------------------------------
// Scanner (sequential; chunk index enables seeking/sharding)
// ---------------------------------------------------------------------------

struct RecScanner {
  FILE* f = nullptr;
  std::vector<uint8_t> chunk;          // decoded records of current chunk
  size_t pos = 0;                      // cursor within chunk
  std::vector<uint8_t> record;         // last record returned

  bool next_chunk() {
    Header h;
    if (fread(&h, 1, sizeof(h), f) != sizeof(h)) return false;
    if (h.magic != kMagic) return false;
    std::vector<uint8_t> payload(h.payload_len);
    if (fread(payload.data(), 1, h.payload_len, f) != h.payload_len)
      return false;
    if ((uint32_t)crc32(0, payload.data(), payload.size()) != h.crc)
      return false;
    if (h.compressor == kZlib) {
      if (!inflate_buf(payload.data(), payload.size(), &chunk, h.raw_len))
        return false;
    } else {
      chunk = std::move(payload);
    }
    pos = 0;
    return true;
  }
};

RecScanner* recio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new RecScanner();
  s->f = f;
  return s;
}

// returns 1 on success, 0 on EOF, -1 on corruption; *len_out = record size
int recio_scanner_next(RecScanner* s, const uint8_t** out,
                       uint32_t* len_out) {
  if (s->pos >= s->chunk.size()) {
    if (!s->next_chunk()) {
      if (feof(s->f)) return 0;
      return -1;
    }
  }
  if (s->pos + 4 > s->chunk.size()) return -1;
  uint32_t len;
  memcpy(&len, s->chunk.data() + s->pos, 4);
  s->pos += 4;
  if (s->pos + len > s->chunk.size()) return -1;
  s->record.assign(s->chunk.begin() + s->pos,
                   s->chunk.begin() + s->pos + len);
  s->pos += len;
  *out = s->record.data();
  *len_out = len;
  return 1;
}

void recio_scanner_close(RecScanner* s) {
  fclose(s->f);
  delete s;
}

// ---------------------------------------------------------------------------
// Threaded prefetching loader: N reader threads fan records into a
// bounded queue (the native analog of the reference's double-buffered /
// threaded reader ops, operators/reader/create_double_buffer_reader_op.cc)
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> files;
  std::queue<std::vector<uint8_t>> q;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t capacity = 256;
  bool done = false;
  bool stop = false;
  std::vector<std::thread> threads;
  std::vector<uint8_t> record;
  size_t active = 0;

  void run(size_t shard, size_t n_shards) {
    for (size_t i = shard; i < files.size(); i += n_shards) {
      RecScanner* s = recio_scanner_open(files[i].c_str());
      if (!s) continue;
      const uint8_t* p;
      uint32_t len;
      while (recio_scanner_next(s, &p, &len) == 1) {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return q.size() < capacity || stop; });
        if (stop) { recio_scanner_close(s); goto out; }
        q.emplace(p, p + len);
        cv_pop.notify_one();
      }
      recio_scanner_close(s);
    }
  out:
    std::unique_lock<std::mutex> lk(mu);
    if (--active == 0) { done = true; cv_pop.notify_all(); }
  }
};

Loader* recio_loader_open(const char** paths, uint32_t n_files,
                          uint32_t n_threads, uint32_t capacity) {
  auto* l = new Loader();
  for (uint32_t i = 0; i < n_files; i++) l->files.emplace_back(paths[i]);
  if (capacity) l->capacity = capacity;
  uint32_t nt = n_threads ? n_threads : 1;
  if (nt > l->files.size()) nt = l->files.size() ? l->files.size() : 1;
  l->active = nt;
  for (uint32_t t = 0; t < nt; t++)
    l->threads.emplace_back(&Loader::run, l, t, nt);
  return l;
}

int recio_loader_next(Loader* l, const uint8_t** out, uint32_t* len_out) {
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_pop.wait(lk, [&] { return !l->q.empty() || l->done; });
  if (l->q.empty()) return 0;
  l->record = std::move(l->q.front());
  l->q.pop();
  l->cv_push.notify_one();
  *out = l->record.data();
  *len_out = (uint32_t)l->record.size();
  return 1;
}

void recio_loader_close(Loader* l) {
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->stop = true;
    l->cv_push.notify_all();
  }
  for (auto& t : l->threads) t.join();
  delete l;
}

}  // extern "C"
