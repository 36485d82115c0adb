// shardio.cc: the port's npz codec on the host (C++17, zlib, threads).
//
// Three parts, bound with ctypes by ``data/native_io.py``:
//
// * the decoder: a ZIP archive of NPY entries, each stored (method 0) or
//   deflated (method 8, raw deflate); NPY format 1.0, 2.0 and 3.0 headers,
//   simple dtypes, C or Fortran order. Every entry's CRC-32 is checked. A
//   bad, truncated or unsupported file gives an error message, never a
//   crash;
// * the prefetch pool: N decode threads behind a ticket API. The caller
//   holds no lock of Python's while a file decodes;
// * the blob-deduplicated encoder: a blob is one NPY entry (header and
//   payload) whose CRC-32 and deflate or store are done once, however many
//   files hold it. Files name their blobs; blob and file jobs run on a
//   thread pool; ``drain`` waits for all of them and reports how many files
//   failed and the last error.
//
// Thread safety of the encoder: the blob registry (id -> blob) is read and
// written only under the encoder's mutex, and a file job holds the blobs it
// needs as shared pointers resolved when it is queued, so a blob registered
// for the next image while this image's files are written never races a
// reader. A blob's results (CRC, deflated bytes, error) are written by the
// one thread that claimed it and read by others only after they saw its
// state DONE under the mutex.
//
// ZIP32 limits: a file whose entry count, entry size or offset does not fit
// the 16- and 32-bit fields (0xFFFF and 0xFFFFFFFF mark ZIP64, so the
// largest values are one less) fails with an error and is not written.

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <new>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr uint32_t kLocalSig = 0x04034b50;
constexpr uint32_t kCentralSig = 0x02014b50;
constexpr uint32_t kEndSig = 0x06054b50;
constexpr uint32_t kZip64LocatorSig = 0x07064b50;
constexpr uint64_t kMax32 = 0xFFFFFFFEull;   // 0xFFFFFFFF marks ZIP64
constexpr uint64_t kMaxEntries = 0xFFFEull;  // 0xFFFF marks ZIP64
constexpr size_t kChunk = size_t(1) << 30;   // zlib lengths are 32-bit
constexpr uint16_t kDosDate = (0 << 9) | (1 << 5) | 1;  // 1980-01-01

uint16_t le16(const unsigned char* p) { return uint16_t(p[0] | (p[1] << 8)); }

uint32_t le32(const unsigned char* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

uint32_t crc_of(uint32_t crc, const char* p, size_t n) {
  uLong c = crc;
  while (n) {
    const size_t k = std::min(n, kChunk);
    c = crc32(c, reinterpret_cast<const Bytef*>(p), uInt(k));
    p += k;
    n -= k;
  }
  return uint32_t(c);
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Entry {
  std::string name;   // the key: the member's name without ".npy"
  std::string descr;  // numpy's dtype string, e.g. "<f2", "|u1"
  bool fortran = false;
  std::vector<int64_t> shape;
  std::vector<char> buf;  // the whole NPY member, header included
  size_t off = 0;         // the payload within buf
};

struct NpzFile {
  std::vector<Entry> entries;
  std::string error;  // empty on success
};

// A POSIX file read at offsets; closes itself.
struct Reader {
  int fd = -1;
  int64_t size = 0;
  ~Reader() {
    if (fd >= 0) close(fd);
  }
  bool read_at(int64_t off, void* dst, size_t n) const {
    if (off < 0 || off > size || int64_t(n) > size - off) return false;
    char* p = static_cast<char*>(dst);
    while (n) {
      const ssize_t got = pread(fd, p, std::min(n, kChunk), off);
      if (got <= 0) return false;
      p += got;
      off += got;
      n -= size_t(got);
    }
    return true;
  }
};

bool inflate_raw(const char* src, size_t n_src, char* dst, size_t n_dst,
                 std::string* err) {
  z_stream s;
  std::memset(&s, 0, sizeof(s));
  if (inflateInit2(&s, -15) != Z_OK) {
    *err = "inflateInit2 failed";
    return false;
  }
  size_t in_left = n_src, out_left = n_dst;
  s.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(src));
  s.next_out = reinterpret_cast<Bytef*>(dst);
  int rc = Z_OK;
  while (rc == Z_OK) {  // Z_BUF_ERROR: no progress with what is left
    if (s.avail_in == 0 && in_left) {
      s.avail_in = uInt(std::min(in_left, kChunk));
      in_left -= s.avail_in;
    }
    if (s.avail_out == 0 && out_left) {
      s.avail_out = uInt(std::min(out_left, kChunk));
      out_left -= s.avail_out;
    }
    rc = inflate(&s, Z_NO_FLUSH);
  }
  const uint64_t total_out = s.total_out;
  inflateEnd(&s);
  if (rc != Z_STREAM_END) {
    *err = "deflate stream corrupt or truncated (zlib " +
           std::to_string(rc) + ")";
    return false;
  }
  if (total_out != n_dst) {
    *err = "deflate stream gave " + std::to_string(total_out) +
           " bytes, the directory says " + std::to_string(n_dst);
    return false;
  }
  return true;
}

// The value after 'key': in an NPY header dict, or npos.
size_t header_value(const std::string& h, const char* key) {
  const std::string k = std::string("'") + key + "'";
  size_t p = h.find(k);
  if (p == std::string::npos) return p;
  p = h.find(':', p + k.size());
  if (p == std::string::npos) return p;
  ++p;
  while (p < h.size() && h[p] == ' ') ++p;
  return p;
}

bool parse_npy(Entry* e, std::string* err) {
  const auto* p = reinterpret_cast<const unsigned char*>(e->buf.data());
  const size_t n = e->buf.size();
  if (n < 10 || std::memcmp(p, "\x93NUMPY", 6) != 0) {
    *err = "not an NPY member (bad magic)";
    return false;
  }
  size_t hlen, hoff;
  if (p[6] == 1) {
    hlen = le16(p + 8);
    hoff = 10;
  } else if (p[6] == 2 || p[6] == 3) {
    if (n < 12) {
      *err = "truncated NPY header";
      return false;
    }
    hlen = le32(p + 8);
    hoff = 12;
  } else {
    *err = "unsupported NPY version " + std::to_string(p[6]);
    return false;
  }
  if (n - hoff < hlen) {
    *err = "truncated NPY header";
    return false;
  }
  const std::string h(e->buf.data() + hoff, hlen);
  e->off = hoff + hlen;

  size_t d = header_value(h, "descr");
  if (d == std::string::npos || d >= h.size()) {
    *err = "NPY header without descr";
    return false;
  }
  if (h[d] != '\'' && h[d] != '"') {
    *err = "structured dtype not supported";
    return false;
  }
  const size_t q = h.find(h[d], d + 1);
  if (q == std::string::npos) {
    *err = "NPY header: bad descr";
    return false;
  }
  e->descr = h.substr(d + 1, q - d - 1);
  if (e->descr.empty() || e->descr.find('O') != std::string::npos) {
    *err = "dtype '" + e->descr + "' not supported";
    return false;
  }

  const size_t f = header_value(h, "fortran_order");
  if (f == std::string::npos) {
    *err = "NPY header without fortran_order";
    return false;
  }
  e->fortran = h.compare(f, 4, "True") == 0;

  const size_t s = header_value(h, "shape");
  if (s == std::string::npos || s >= h.size() || h[s] != '(') {
    *err = "NPY header: bad shape";
    return false;
  }
  const size_t close_paren = h.find(')', s);
  if (close_paren == std::string::npos) {
    *err = "NPY header: bad shape";
    return false;
  }
  e->shape.clear();
  size_t i = s + 1;
  while (i < close_paren) {
    while (i < close_paren && (h[i] == ' ' || h[i] == ',')) ++i;
    if (i >= close_paren) break;
    char* end = nullptr;
    const long long v = std::strtoll(h.c_str() + i, &end, 10);
    if (end == h.c_str() + i || v < 0) {
      *err = "NPY header: bad shape";
      return false;
    }
    e->shape.push_back(v);
    i = size_t(end - h.c_str());
  }
  return true;
}

NpzFile* load_npz(const std::string& path) {
  auto* f = new NpzFile();
  auto fail = [&](const std::string& msg) {
    f->entries.clear();
    f->error = msg;
    return f;
  };
  Reader r;
  r.fd = open(path.c_str(), O_RDONLY);
  if (r.fd < 0) return fail(std::string("cannot open: ") + strerror(errno));
  r.size = lseek(r.fd, 0, SEEK_END);
  if (r.size < 0) return fail(std::string("cannot seek: ") + strerror(errno));
  if (r.size < 22) return fail("not a zip file (too short)");

  // The end-of-central-directory record: within the last 22 + 65535 bytes.
  const int64_t tail_len = std::min<int64_t>(r.size, 22 + 65535);
  std::vector<unsigned char> tail(static_cast<size_t>(tail_len));
  if (!r.read_at(r.size - tail_len, tail.data(), tail.size()))
    return fail("cannot read the end of the file");
  int64_t eocd = -1;
  for (int64_t i = tail_len - 22; i >= 0; --i) {
    if (le32(&tail[size_t(i)]) == kEndSig) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) return fail("not a zip file (no end of central directory)");
  if (eocd >= 20 && le32(&tail[size_t(eocd - 20)]) == kZip64LocatorSig)
    return fail("ZIP64 archives are not supported");
  const unsigned char* e = &tail[size_t(eocd)];
  const uint32_t n_entries = le16(e + 10);
  const uint32_t cd_size = le32(e + 12);
  const uint32_t cd_off = le32(e + 16);
  std::vector<unsigned char> cd(cd_size);
  if (!r.read_at(cd_off, cd.data(), cd.size()))
    return fail("truncated central directory");

  size_t pos = 0;
  for (uint32_t k = 0; k < n_entries; ++k) {
    if (cd.size() - pos < 46 || le32(&cd[pos]) != kCentralSig)
      return fail("bad central directory entry " + std::to_string(k));
    const unsigned char* c = &cd[pos];
    const uint16_t flags = le16(c + 8);
    const uint16_t method = le16(c + 10);
    const uint32_t crc = le32(c + 16);
    const uint32_t csize = le32(c + 20);
    const uint32_t usize = le32(c + 24);
    const size_t nlen = le16(c + 28), xlen = le16(c + 30), clen = le16(c + 32);
    const uint32_t lho = le32(c + 42);
    if (cd.size() - pos - 46 < nlen)
      return fail("bad central directory entry " + std::to_string(k));
    const std::string member(reinterpret_cast<const char*>(c + 46), nlen);
    pos += 46 + nlen + xlen + clen;
    if (pos > cd.size())
      return fail("bad central directory entry " + std::to_string(k));
    const std::string where = "member '" + member + "': ";
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu || lho == 0xFFFFFFFFu)
      return fail(where + "ZIP64 sizes are not supported");
    if (flags & 1) return fail(where + "encrypted");

    unsigned char lh[30];
    if (!r.read_at(lho, lh, sizeof(lh)) || le32(lh) != kLocalSig)
      return fail(where + "bad local header");
    const int64_t data_off = int64_t(lho) + 30 + le16(lh + 26) + le16(lh + 28);

    Entry ent;
    if (method == 0) {
      if (csize != usize) return fail(where + "stored sizes differ");
      ent.buf.resize(usize);
      if (!r.read_at(data_off, ent.buf.data(), usize))
        return fail(where + "truncated");
    } else if (method == 8) {
      // deflate expands at most ~1032x: refuse directories that claim more
      if (uint64_t(usize) > uint64_t(csize) * 1032 + 1024)
        return fail(where + "implausible uncompressed size");
      std::vector<char> raw(csize);
      if (!r.read_at(data_off, raw.data(), csize))
        return fail(where + "truncated");
      ent.buf.resize(usize);
      std::string zerr;
      if (!inflate_raw(raw.data(), csize, ent.buf.data(), usize, &zerr))
        return fail(where + zerr);
    } else {
      return fail(where + "unsupported zip method " + std::to_string(method));
    }
    if (crc_of(0, ent.buf.data(), ent.buf.size()) != crc)
      return fail(where + "CRC-32 mismatch");
    std::string nerr;
    if (!parse_npy(&ent, &nerr)) return fail(where + nerr);
    ent.name = member.size() > 4 &&
                       member.compare(member.size() - 4, 4, ".npy") == 0
                   ? member.substr(0, member.size() - 4)
                   : member;
    f->entries.push_back(std::move(ent));
  }
  return f;
}

NpzFile* load_npz_noexcept(const std::string& path) {
  try {
    return load_npz(path);
  } catch (const std::bad_alloc&) {
    auto* f = new NpzFile();
    f->error = "out of memory";
    return f;
  }
}

// ---------------------------------------------------------------------------
// Prefetch pool
// ---------------------------------------------------------------------------

struct Pool {
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, std::string>> jobs;
  std::unordered_map<int64_t, NpzFile*> done;
  std::set<int64_t> outstanding;  // submitted, not taken yet
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  bool stop = false;
  int64_t next_ticket = 1;

  explicit Pool(int threads) {
    for (int i = 0; i < threads; ++i) workers.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      std::pair<int64_t, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [this] { return stop || !jobs.empty(); });
        if (stop) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      NpzFile* f = load_npz_noexcept(job.second);
      {
        std::lock_guard<std::mutex> lk(mu);
        done[job.first] = f;
      }
      cv_done.notify_all();
    }
  }

  int64_t submit(const char* path) {
    int64_t t;
    {
      std::lock_guard<std::mutex> lk(mu);
      t = next_ticket++;
      jobs.emplace_back(t, path);
      outstanding.insert(t);
    }
    cv_job.notify_one();
    return t;
  }

  // The decoded file of ``ticket``, or nullptr for a ticket that was never
  // handed out or was taken already.
  NpzFile* take(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    if (!outstanding.count(ticket)) return nullptr;
    cv_done.wait(lk, [&] { return done.count(ticket) > 0; });
    NpzFile* f = done[ticket];
    done.erase(ticket);
    outstanding.erase(ticket);
    return f;
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& w : workers) w.join();
    for (auto& kv : done) delete kv.second;
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// numpy's NPY 1.0 header for a C-order array (``np.lib.format``'s layout:
// the dict padded with spaces to a multiple of 64 bytes, ending in '\n').
std::string npy_header(const std::string& descr, const std::vector<int64_t>& shape) {
  std::string d = "{'descr': '" + descr + "', 'fortran_order': False, 'shape': (";
  for (size_t i = 0; i < shape.size(); ++i) {
    if (i) d += ", ";
    d += std::to_string(shape[i]);
  }
  if (shape.size() == 1) d += ",";
  d += "), }";
  // format 1.0 has a 16-bit header length; 2.0 (a 32-bit one) past it
  const size_t prefix = 10 + d.size() + 1 <= 0xFFFF ? 10 : 12;
  d.append((64 - (prefix + d.size() + 1) % 64) % 64, ' ');
  d += '\n';
  std::string h = "\x93NUMPY";
  h += char(prefix == 10 ? 1 : 2);
  h += '\x00';
  for (size_t i = 0; i < prefix - 8; ++i) h += char((d.size() >> (8 * i)) & 0xff);
  return h + d;
}

struct Blob {
  // set when registered, read-only afterwards
  std::string header;
  const char* src = nullptr;        // borrowed from the caller until drain
  std::vector<int64_t> shape;
  std::vector<int64_t> strides;     // bytes; empty when src is C-contiguous
  size_t itemsize = 0, nbytes = 0;
  int method = 8, level = 1;
  // written by the thread that claimed the blob, read once it is DONE
  std::vector<char> packed;         // the C-order copy of a strided source
  std::vector<char> comp;           // the deflate stream (method 8)
  uint32_t crc = 0;
  std::string error;
  // guarded by the encoder's mutex
  enum State { QUEUED, RUNNING, DONE } state = QUEUED;

  const char* payload() const { return strides.empty() ? src : packed.data(); }
  uint64_t usize() const { return header.size() + nbytes; }
  uint64_t csize() const { return method == 8 ? comp.size() : usize(); }
};

// dst[i * n1 + j] = src[i * s2 + j * s1] for an n2 x n1 plane of T, the
// inner loop along the axis the source holds closer together.
template <typename T>
char* pack_plane(char* dst, const char* src, int64_t n2, int64_t s2,
                 int64_t n1, int64_t s1) {
  constexpr int64_t k = sizeof(T);
  if (std::llabs(s2) < std::llabs(s1)) {  // e.g. an HWC view of CHW data
    for (int64_t j = 0; j < n1; ++j) {
      const char* col = src + j * s1;
      for (int64_t i = 0; i < n2; ++i)
        std::memcpy(dst + (i * n1 + j) * k, col + i * s2, k);
    }
    return dst + n2 * n1 * k;
  }
  for (int64_t i = 0; i < n2; ++i) {
    const char* row = src + i * s2;
    for (int64_t j = 0; j < n1; ++j, dst += k)
      std::memcpy(dst, row + j * s1, k);
  }
  return dst;
}

// Copy a strided array into C order: the last two axes as a plane (an HWC
// view of CHW data is one plane a row), an odometer over the others.
void pack(const Blob& b, char* dst) {
  if (b.nbytes == 0) return;
  std::vector<int64_t> shape = b.shape, strides = b.strides;
  while (shape.size() < 2) {  // a 0-d or 1-d array is a plane of one row
    shape.insert(shape.begin(), 1);
    strides.insert(strides.begin(), 0);
  }
  const size_t nd = shape.size();
  const int64_t n2 = shape[nd - 2], s2 = strides[nd - 2];
  const int64_t n1 = shape[nd - 1], s1 = strides[nd - 1];
  std::vector<int64_t> idx(nd - 2, 0);  // the odometer over the outer axes
  for (;;) {
    const char* p = b.src;
    for (size_t d = 0; d + 2 < nd; ++d) p += idx[d] * strides[d];
    switch (b.itemsize) {  // a constant size lets memcpy become one load
      case 1: dst = pack_plane<uint8_t>(dst, p, n2, s2, n1, s1); break;
      case 2: dst = pack_plane<uint16_t>(dst, p, n2, s2, n1, s1); break;
      case 4: dst = pack_plane<uint32_t>(dst, p, n2, s2, n1, s1); break;
      case 8: dst = pack_plane<uint64_t>(dst, p, n2, s2, n1, s1); break;
      default:
        for (int64_t i = 0; i < n2; ++i)
          for (int64_t j = 0; j < n1; ++j, dst += b.itemsize)
            std::memcpy(dst, p + i * s2 + j * s1, b.itemsize);
    }
    int d = int(nd) - 3;
    for (; d >= 0; --d) {
      if (++idx[size_t(d)] < shape[size_t(d)]) break;
      idx[size_t(d)] = 0;
    }
    if (d < 0) return;
  }
}

// Pack, CRC and (method 8) deflate one claimed blob; no lock held.
void process_blob(Blob* b) {
  try {
    if (!b->strides.empty()) {
      b->packed.resize(b->nbytes);
      pack(*b, b->packed.data());
    }
    const char* data = b->payload();
    b->crc = crc_of(crc_of(0, b->header.data(), b->header.size()), data, b->nbytes);
    if (b->method != 8) return;
    z_stream s;
    std::memset(&s, 0, sizeof(s));
    if (deflateInit2(&s, b->level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) {
      b->error = "deflateInit2 failed";
      return;
    }
    b->comp.resize(deflateBound(&s, uLong(b->usize())));
    s.next_out = reinterpret_cast<Bytef*>(b->comp.data());
    size_t out_left = b->comp.size();
    // the header, then the payload in chunks, then finish
    const std::pair<const char*, size_t> parts[2] = {
        {b->header.data(), b->header.size()}, {data, b->nbytes}};
    int rc = Z_OK;
    for (int part = 0; part < 2 && rc == Z_OK; ++part) {
      const char* p = parts[part].first;
      size_t left = parts[part].second;
      while (left && rc == Z_OK) {
        const size_t k = std::min(left, kChunk);
        s.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(p));
        s.avail_in = uInt(k);
        while (s.avail_in && rc == Z_OK) {
          if (s.avail_out == 0) {
            s.avail_out = uInt(std::min(out_left, kChunk));
            out_left -= s.avail_out;
          }
          rc = deflate(&s, Z_NO_FLUSH);
        }
        p += k;
        left -= k;
      }
    }
    while (rc == Z_OK) {
      if (s.avail_out == 0) {
        s.avail_out = uInt(std::min(out_left, kChunk));
        out_left -= s.avail_out;
      }
      rc = deflate(&s, Z_FINISH);
    }
    if (rc != Z_STREAM_END) b->error = "deflate failed (zlib " + std::to_string(rc) + ")";
    b->comp.resize(s.total_out);
    deflateEnd(&s);
    if (!b->error.empty()) b->comp.clear();
  } catch (const std::bad_alloc&) {
    b->error = "out of memory";
  }
}

struct FileJob {
  std::string path;
  std::vector<std::string> names;  // member names, ".npy" included
  std::vector<std::shared_ptr<Blob>> blobs;
};

class Writer {
 public:
  explicit Writer(const std::string& path) : f_(std::fopen(path.c_str(), "wb")) {
    if (f_) std::setvbuf(f_, nullptr, _IOFBF, 1 << 20);
  }
  ~Writer() {
    if (f_) std::fclose(f_);
  }
  bool ok() const { return f_ != nullptr && good_; }
  void bytes(const void* p, size_t n) {
    if (good_ && n && std::fwrite(p, 1, n, f_) != n) good_ = false;
  }
  void u16(uint32_t v) {
    const unsigned char b[2] = {uint8_t(v), uint8_t(v >> 8)};
    bytes(b, 2);
  }
  void u32(uint64_t v) {
    const unsigned char b[4] = {uint8_t(v), uint8_t(v >> 8), uint8_t(v >> 16),
                                uint8_t(v >> 24)};
    bytes(b, 4);
  }
  bool finish() {
    if (!f_) return false;
    const bool closed = std::fclose(f_) == 0;
    f_ = nullptr;
    return good_ && closed;
  }

 private:
  std::FILE* f_;
  bool good_ = true;
};

// Write one file from DONE blobs; "" on success, else the error (and no file).
std::string write_file(const FileJob& job) {
  const size_t n = job.names.size();
  if (n > kMaxEntries)
    return job.path + ": " + std::to_string(n) + " entries, more than a zip32 "
           "file holds (" + std::to_string(kMaxEntries) + ")";
  std::vector<uint64_t> offsets(n);
  uint64_t off = 0, cd_size = 0;
  for (size_t i = 0; i < n; ++i) {
    const Blob& b = *job.blobs[i];
    if (job.names[i].size() > 0xFFFF) return job.path + ": member name too long";
    if (b.usize() > kMax32 || b.csize() > kMax32)
      return job.path + ": member '" + job.names[i] + "' of " +
             std::to_string(b.usize()) + " bytes exceeds zip32";
    offsets[i] = off;
    off += 30 + job.names[i].size() + b.csize();
    cd_size += 46 + job.names[i].size();
  }
  for (size_t i = 0; i < n; ++i)
    if (offsets[i] > kMax32) return job.path + ": offset exceeds zip32";
  if (off > kMax32 || cd_size > kMax32 || off + cd_size > kMax32)
    return job.path + ": central directory beyond zip32";

  Writer w(job.path);
  if (!w.ok()) return "cannot open " + job.path + ": " + strerror(errno);
  for (size_t i = 0; i < n; ++i) {
    const Blob& b = *job.blobs[i];
    w.u32(kLocalSig);
    w.u16(20), w.u16(0), w.u16(uint32_t(b.method));
    w.u16(0), w.u16(kDosDate);
    w.u32(b.crc), w.u32(b.csize()), w.u32(b.usize());
    w.u16(uint32_t(job.names[i].size())), w.u16(0);
    w.bytes(job.names[i].data(), job.names[i].size());
    if (b.method == 8) {
      w.bytes(b.comp.data(), b.comp.size());
    } else {
      w.bytes(b.header.data(), b.header.size());
      w.bytes(b.payload(), b.nbytes);
    }
  }
  for (size_t i = 0; i < n; ++i) {
    const Blob& b = *job.blobs[i];
    w.u32(kCentralSig);
    w.u16(20), w.u16(20), w.u16(0), w.u16(uint32_t(b.method));
    w.u16(0), w.u16(kDosDate);
    w.u32(b.crc), w.u32(b.csize()), w.u32(b.usize());
    w.u16(uint32_t(job.names[i].size())), w.u16(0), w.u16(0);
    w.u16(0), w.u16(0), w.u32(0);
    w.u32(offsets[i]);
    w.bytes(job.names[i].data(), job.names[i].size());
  }
  w.u32(kEndSig);
  w.u16(0), w.u16(0), w.u16(uint32_t(n)), w.u16(uint32_t(n));
  w.u32(cd_size), w.u32(off);
  w.u16(0);
  if (!w.finish()) {
    std::remove(job.path.c_str());
    return "write failed for " + job.path;
  }
  return "";
}

struct Encoder {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_blob, cv_idle;
  std::unordered_map<int64_t, std::shared_ptr<Blob>> registry;
  std::deque<std::shared_ptr<Blob>> blob_q;
  std::deque<FileJob> file_q;
  int running = 0;  // jobs taken off a queue and not finished
  bool stop = false;
  int64_t next_blob = 1;
  int64_t failed = 0;
  std::string last_error;
  double busy_s = 0.0;

  explicit Encoder(int threads) {
    for (int i = 0; i < threads; ++i) workers.emplace_back([this] { run(); });
  }

  ~Encoder() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& w : workers) w.join();
  }

  // Claim-or-wait for each blob of a file: an unclaimed blob is processed
  // by the file's own thread, so threads never wait on queued work.
  // Returns the seconds spent waiting for other threads' blobs.
  double ensure_blobs(const FileJob& job, std::string* err) {
    double waited = 0.0;
    for (const auto& b : job.blobs) {
      std::unique_lock<std::mutex> lk(mu);
      if (b->state == Blob::QUEUED) {
        b->state = Blob::RUNNING;
        lk.unlock();
        process_blob(b.get());
        lk.lock();
        b->state = Blob::DONE;
        cv_blob.notify_all();
      } else if (b->state == Blob::RUNNING) {
        const auto t0 = std::chrono::steady_clock::now();
        cv_blob.wait(lk, [&] { return b->state == Blob::DONE; });
        waited += std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
      }
      if (!b->error.empty() && err->empty()) *err = b->error;
    }
    return waited;
  }

  void run() {
    for (;;) {
      std::shared_ptr<Blob> blob;
      FileJob job;
      bool have_file = false;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [this] { return stop || !blob_q.empty() || !file_q.empty(); });
        if (blob_q.empty() && file_q.empty()) return;  // stop, nothing left
        if (!blob_q.empty()) {  // blobs first: the files need them
          blob = std::move(blob_q.front());
          blob_q.pop_front();
          if (blob->state != Blob::QUEUED) continue;  // a file took it
          blob->state = Blob::RUNNING;
        } else {
          job = std::move(file_q.front());
          file_q.pop_front();
          have_file = true;
        }
        ++running;
      }
      const auto t0 = std::chrono::steady_clock::now();
      double waited = 0.0;
      std::string err;
      if (have_file) {
        waited = ensure_blobs(job, &err);
        if (err.empty()) {
          err = write_file(job);
        } else {
          err = job.path + ": " + err;
        }
      } else {
        process_blob(blob.get());
      }
      const double dt =
          std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!have_file) {
          blob->state = Blob::DONE;
          cv_blob.notify_all();
        }
        if (!err.empty()) {
          ++failed;
          last_error = err;
        }
        busy_s += dt - waited;
        --running;
      }
      cv_idle.notify_all();
    }
  }

  int64_t add_blob(const void* data, const char* descr, int ndim,
                   const int64_t* shape, const int64_t* strides,
                   int64_t itemsize, int method, int level) {
    auto b = std::make_shared<Blob>();
    b->shape.assign(shape, shape + ndim);
    b->src = static_cast<const char*>(data);
    b->itemsize = size_t(itemsize);
    size_t count = 1;
    for (int i = 0; i < ndim; ++i) count *= size_t(shape[i]);
    b->nbytes = count * b->itemsize;
    if (strides) b->strides.assign(strides, strides + ndim);
    b->header = npy_header(descr, b->shape);
    b->method = method;
    b->level = level;
    int64_t id;
    {
      std::lock_guard<std::mutex> lk(mu);
      id = next_blob++;
      registry[id] = b;
      blob_q.push_back(b);
    }
    cv_work.notify_one();
    return id;
  }

  // Queue one file; -1 (nothing queued) if a blob id is unknown.
  int64_t add_file(const char* path, int n, const char** names, const int64_t* ids) {
    FileJob job;
    job.path = path;
    job.names.reserve(size_t(n));
    for (int i = 0; i < n; ++i) job.names.emplace_back(std::string(names[i]) + ".npy");
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int i = 0; i < n; ++i) {
        auto it = registry.find(ids[i]);
        if (it == registry.end()) return -1;
        job.blobs.push_back(it->second);
      }
      file_q.push_back(std::move(job));
    }
    cv_work.notify_one();
    return 0;
  }

  // Wait for every queued job; returns the failed files since the last
  // drain and forgets every blob (the caller may release its arrays).
  int64_t drain(std::string* err) {
    std::unique_lock<std::mutex> lk(mu);
    cv_idle.wait(lk, [this] { return blob_q.empty() && file_q.empty() && running == 0; });
    const int64_t fails = failed;
    *err = last_error;
    failed = 0;
    last_error.clear();
    registry.clear();
    return fails;
  }
};

void copy_out(const std::string& s, char* buf, int64_t len) {
  if (len <= 0) return;
  const size_t n = std::min(s.size(), size_t(len - 1));
  std::memcpy(buf, s.data(), n);
  buf[n] = '\0';
}

}  // namespace

extern "C" {

void* ofd_npz_load(const char* path) { return load_npz_noexcept(path); }

const char* ofd_npz_error(void* h) { return static_cast<NpzFile*>(h)->error.c_str(); }

int ofd_npz_count(void* h) { return int(static_cast<NpzFile*>(h)->entries.size()); }

// Entry i's name, descr, order and rank; its shape into ``shape`` (ndim
// values, at most ``cap``) and its payload's byte count into ``nbytes``.
int ofd_npz_entry(void* h, int i, const char** name, const char** descr,
                  int* fortran, int64_t* shape, int cap, int64_t* nbytes) {
  const Entry& e = static_cast<NpzFile*>(h)->entries[size_t(i)];
  *name = e.name.c_str();
  *descr = e.descr.c_str();
  *fortran = e.fortran ? 1 : 0;
  for (size_t d = 0; d < e.shape.size() && int(d) < cap; ++d) shape[d] = e.shape[d];
  *nbytes = int64_t(e.buf.size() - e.off);
  return int(e.shape.size());
}

void ofd_npz_copy(void* h, int i, void* dst) {
  const Entry& e = static_cast<NpzFile*>(h)->entries[size_t(i)];
  std::memcpy(dst, e.buf.data() + e.off, e.buf.size() - e.off);
}

void ofd_npz_free(void* h) { delete static_cast<NpzFile*>(h); }

void* ofd_pool_new(int threads) { return new Pool(threads > 0 ? threads : 1); }

int64_t ofd_pool_submit(void* p, const char* path) { return static_cast<Pool*>(p)->submit(path); }

void* ofd_pool_take(void* p, int64_t ticket) { return static_cast<Pool*>(p)->take(ticket); }

void ofd_pool_free(void* p) { delete static_cast<Pool*>(p); }

void* ofd_enc_new(int threads) { return new Encoder(threads > 0 ? threads : 1); }

int64_t ofd_enc_blob(void* e, const void* data, const char* descr, int ndim,
                     const int64_t* shape, const int64_t* strides,
                     int64_t itemsize, int method, int level) {
  return static_cast<Encoder*>(e)->add_blob(data, descr, ndim, shape, strides,
                                            itemsize, method, level);
}

int64_t ofd_enc_file(void* e, const char* path, int n, const char** names,
                     const int64_t* ids) {
  return static_cast<Encoder*>(e)->add_file(path, n, names, ids);
}

int64_t ofd_enc_drain(void* e, char* err, int64_t len) {
  std::string msg;
  const int64_t fails = static_cast<Encoder*>(e)->drain(&msg);
  copy_out(msg, err, len);
  return fails;
}

double ofd_enc_busy_s(void* e) {
  auto* enc = static_cast<Encoder*>(e);
  std::lock_guard<std::mutex> lk(enc->mu);
  return enc->busy_s;
}

void ofd_enc_free(void* e) { delete static_cast<Encoder*>(e); }

}  // extern "C"
