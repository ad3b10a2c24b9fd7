// Copied from vlaser_tpu/native/dataloader.cpp for the PyTorch port. The
// only change is this header and the path of its Python binding, which is
// vlaser_tpu_torch/data/native_loader.py here; it includes the port's own
// image_ops.cpp, and native/build.py compiles it into vlaser_tpu_torch/_build/.
//
// Native threaded image loader: the data-pipeline equivalent of the
// reference's torch DataLoader worker pool (multiprocess PIL/cv2 decode in
// internvl/train/dataset.py + torch DataLoader workers). Here: a C++ worker
// pool that reads, JPEG-decodes (libjpeg), Lanczos/bicubic-resizes and
// ImageNet-normalizes images fully outside the Python GIL, with a bounded
// completion queue. Python threads stay free to run host-side tokenization
// and device dispatch while the next batch's pixels are produced.
//
// C ABI consumed via ctypes (vlaser_tpu_torch/data/native_loader.py). Non-JPEG
// inputs return a status so the caller falls back to PIL.

#include <condition_variable>
#include <cstdio>
#include <csetjmp>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>

#include <jpeglib.h>

#include "image_ops.cpp"  // resample_one / normalization constants

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG byte buffer into RGB uint8 [h, w, 3]. Returns false on any
// decode error (caller falls back).
bool decode_jpeg(const std::string& bytes, std::vector<uint8_t>* out, int* h,
                 int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo,
               reinterpret_cast<const unsigned char*>(bytes.data()),
               bytes.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  out->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

struct Job {
  long long id;
  std::string path;
  int oh, ow;
  int mode;       // 0 bicubic, 1 lanczos4
  int normalize;  // 1 = /255 + ImageNet mean/std
};

struct Result {
  long long id;
  int status;  // 0 ok; -1 io error; -2 decode error
  std::vector<float> pixels;  // [oh, ow, 3]
};

class Loader {
 public:
  Loader(int num_threads, int capacity) : capacity_(capacity) {
    for (int i = 0; i < std::max(1, num_threads); ++i)
      workers_.emplace_back([this] { run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_jobs_.notify_all();
    cv_done_.notify_all();
    cv_space_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Blocks while `capacity` jobs are already in flight (backpressure).
  void submit(const Job& job) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] {
      return stop_ || in_flight_ + static_cast<int>(done_.size()) < capacity_;
    });
    if (stop_) return;
    jobs_.push_back(job);
    ++in_flight_;
    cv_jobs_.notify_one();
  }

  // Non-blocking submit; false when the pipeline is at capacity.
  bool try_submit(const Job& job) {
    std::lock_guard<std::mutex> lk(mu_);
    if (stop_ || in_flight_ + static_cast<int>(done_.size()) >= capacity_)
      return false;
    jobs_.push_back(job);
    ++in_flight_;
    cv_jobs_.notify_one();
    return true;
  }

  // Returns true with a result, false on timeout.
  bool next(Result* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cv_done_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                           [this] { return stop_ || !done_.empty(); }))
      return false;
    if (done_.empty()) return false;
    *out = std::move(done_.front());
    done_.pop_front();
    cv_space_.notify_one();
    return true;
  }

 private:
  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_jobs_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_) return;
        job = std::move(jobs_.front());
        jobs_.pop_front();
      }
      Result res;
      res.id = job.id;
      res.status = 0;
      std::string bytes;
      {
        FILE* f = std::fopen(job.path.c_str(), "rb");
        if (!f) {
          res.status = -1;
        } else {
          std::fseek(f, 0, SEEK_END);
          long n = std::ftell(f);
          std::fseek(f, 0, SEEK_SET);
          bytes.resize(static_cast<size_t>(n));
          if (std::fread(bytes.data(), 1, n, f) != static_cast<size_t>(n))
            res.status = -1;
          std::fclose(f);
        }
      }
      std::vector<uint8_t> rgb;
      int h = 0, w = 0;
      if (res.status == 0 && !decode_jpeg(bytes, &rgb, &h, &w))
        res.status = -2;
      if (res.status == 0) {
        res.pixels.resize(static_cast<size_t>(job.oh) * job.ow * 3);
        const bool lanc = job.mode == 1;
        resample_one(rgb.data(), h, w, res.pixels.data(), job.oh, job.ow,
                     lanc, lanc ? 4 : 2);
        if (job.normalize) {
          for (size_t p = 0;
               p < static_cast<size_t>(job.oh) * job.ow; ++p) {
            for (int c = 0; c < 3; ++c) {
              float v = res.pixels[p * 3 + c] * (1.0f / 255.0f);
              res.pixels[p * 3 + c] = (v - kMean[c]) / kStd[c];
            }
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        --in_flight_;
        done_.push_back(std::move(res));
      }
      cv_done_.notify_one();
    }
  }

  const int capacity_;
  std::mutex mu_;
  std::condition_variable cv_jobs_, cv_done_, cv_space_;
  std::deque<Job> jobs_;
  std::deque<Result> done_;
  int in_flight_ = 0;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* dl_create(int num_threads, int capacity) {
  return new Loader(num_threads, capacity);
}

void dl_destroy(void* h) { delete static_cast<Loader*>(h); }

void dl_submit(void* h, long long job_id, const char* path, int oh, int ow,
               int mode, int normalize) {
  Job j;
  j.id = job_id;
  j.path = path;
  j.oh = oh;
  j.ow = ow;
  j.mode = mode;
  j.normalize = normalize;
  static_cast<Loader*>(h)->submit(j);
}

// Header-only probe: JPEG dimensions without a full decode (the dynamic
// tiling grid needs (w, h) before choosing the resize target). Returns 0 on
// success, negative on IO/parse failure.
int dl_probe(const char* path, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return -2;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Non-blocking submit: returns 1 if accepted, 0 when the pipeline is at
// capacity (caller buffers and retries after draining dl_next).
int dl_try_submit(void* h, long long job_id, const char* path, int oh, int ow,
                  int mode, int normalize) {
  Job j;
  j.id = job_id;
  j.path = path;
  j.oh = oh;
  j.ow = ow;
  j.mode = mode;
  j.normalize = normalize;
  return static_cast<Loader*>(h)->try_submit(j) ? 1 : 0;
}

// Pops one completed job. Returns 1 and fills (job_id, status, dst) on
// success; 0 on timeout. dst must hold oh*ow*3 floats (the submit's dims);
// it is left untouched when status != 0.
int dl_next(void* h, long long* job_id, int* status, float* dst,
            long long dst_floats, int timeout_ms) {
  Result res;
  if (!static_cast<Loader*>(h)->next(&res, timeout_ms)) return 0;
  *job_id = res.id;
  *status = res.status;
  if (res.status == 0 &&
      static_cast<long long>(res.pixels.size()) <= dst_floats) {
    std::memcpy(dst, res.pixels.data(), res.pixels.size() * sizeof(float));
  } else if (res.status == 0) {
    *status = -3;  // caller buffer too small
  }
  return 1;
}

// Synchronous batch decode: paths (NUL-joined), one thread per image via
// the pool — releases the GIL for the whole batch from Python's view.
// statuses[i]: 0 ok / negative like dl_next. dst [n, oh, ow, 3].
void dl_decode_batch(void* h, const char* const* paths, int n, int oh, int ow,
                     int mode, int normalize, float* dst, int* statuses) {
  Loader* loader = static_cast<Loader*>(h);
  const long long per = static_cast<long long>(oh) * ow * 3;
  int submitted = 0, received = 0;
  // interleave submit/drain so batches larger than the pipeline capacity
  // cannot deadlock the single caller thread
  while (received < n) {
    while (submitted < n) {
      Job j;
      j.id = submitted;
      j.path = paths[submitted];
      j.oh = oh;
      j.ow = ow;
      j.mode = mode;
      j.normalize = normalize;
      if (!loader->try_submit(j)) break;
      ++submitted;
    }
    Result res;
    if (!loader->next(&res, 60'000)) continue;
    statuses[res.id] = res.status;
    if (res.status == 0)
      std::memcpy(dst + res.id * per, res.pixels.data(),
                  per * sizeof(float));
    ++received;
  }
}

}  // extern "C"
