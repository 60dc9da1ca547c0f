// hso_io: native dataset reader with multi-threaded decode prefetch.
//
// Native equivalent of the reference's IO layer (ImageReader.cpp +
// the implicit decode-on-the-tracking-thread of test_dataset.cpp): directory
// scan, grayscale decode, resize — but decoded AHEAD of the pipeline by a
// worker pool into a bounded ring, so the host tracking loop (mostly
// waiting on device steps) never stalls on image decode.
//
// C API consumed from Python via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Slot {
  int index = -1;
  std::vector<uint8_t> data;
};

struct Reader {
  std::vector<std::string> files;
  int width = 0, height = 0;

  // prefetch state
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, std::vector<uint8_t>> ready;   // decoded frames by index
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  int end_index = 0;
  size_t max_ready = 8;
  std::atomic<bool> stopping{false};

  ~Reader() { stop(); }

  void stop() {
    stopping = true;
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }

  bool decode(int idx, std::vector<uint8_t>* out) const {
    cv::Mat img = cv::imread(files[idx], cv::IMREAD_GRAYSCALE);
    if (img.empty()) return false;
    if (img.cols != width || img.rows != height)
      cv::resize(img, img, cv::Size(width, height), 0, 0, cv::INTER_LINEAR);
    out->assign(img.data, img.data + size_t(width) * height);
    return true;
  }

  void worker() {
    while (!stopping) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= end_index) return;
      std::vector<uint8_t> buf;
      bool ok = decode(idx, &buf);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stopping || ready.size() < max_ready ||
               idx < next_to_consume + int(max_ready);
      });
      if (stopping) return;
      if (!ok) buf.assign(size_t(width) * height, 0);
      ready.emplace(idx, std::move(buf));
      cv_ready.notify_all();
    }
  }
};

bool has_ext(const std::string& f) {
  auto dot = f.rfind('.');
  if (dot == std::string::npos) return false;
  std::string e = f.substr(dot);
  std::transform(e.begin(), e.end(), e.begin(), ::tolower);
  return e == ".png" || e == ".jpg" || e == ".jpeg" || e == ".bmp";
}

}  // namespace

extern "C" {

void* hso_reader_open(const char* folder, int width, int height) {
  DIR* d = opendir(folder);
  if (!d) return nullptr;
  auto* r = new Reader();
  r->width = width;
  r->height = height;
  std::string base(folder);
  if (!base.empty() && base.back() != '/') base += '/';
  while (dirent* e = readdir(d)) {
    std::string name(e->d_name);
    if (has_ext(name)) r->files.push_back(base + name);
  }
  closedir(d);
  std::sort(r->files.begin(), r->files.end());
  return r;
}

int hso_reader_count(void* h) { return int(static_cast<Reader*>(h)->files.size()); }

const char* hso_reader_path(void* h, int idx) {
  auto* r = static_cast<Reader*>(h);
  if (idx < 0 || idx >= int(r->files.size())) return "";
  return r->files[idx].c_str();
}

// Random access (synchronous decode).
int hso_reader_read(void* h, int idx, uint8_t* out) {
  auto* r = static_cast<Reader*>(h);
  if (idx < 0 || idx >= int(r->files.size())) return -1;
  std::vector<uint8_t> buf;
  if (!r->decode(idx, &buf)) return -2;
  std::memcpy(out, buf.data(), buf.size());
  return 0;
}

// Start sequential prefetch of [start, end) with a worker pool.
int hso_reader_start(void* h, int start, int end, int n_workers, int depth) {
  auto* r = static_cast<Reader*>(h);
  r->stop();
  r->stopping = false;
  r->ready.clear();
  r->next_to_decode = start;
  r->next_to_consume = start;
  r->end_index = std::min<int>(end, r->files.size());
  r->max_ready = depth > 0 ? depth : 8;
  int n = std::max(1, n_workers);
  for (int i = 0; i < n; ++i) r->workers.emplace_back(&Reader::worker, r);
  return 0;
}

// Blocking pop of the next sequential frame; returns its index or -1 at end.
int hso_reader_next(void* h, uint8_t* out) {
  auto* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> lk(r->mu);
  int idx = r->next_to_consume;
  if (idx >= r->end_index) return -1;
  r->cv_ready.wait(lk, [&] { return r->stopping || r->ready.count(idx); });
  if (!r->ready.count(idx)) return -1;
  auto buf = std::move(r->ready[idx]);
  r->ready.erase(idx);
  r->next_to_consume = idx + 1;
  r->cv_space.notify_all();
  lk.unlock();
  std::memcpy(out, buf.data(), buf.size());
  return idx;
}

void hso_reader_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
