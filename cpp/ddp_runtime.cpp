// ddp_jax native runtime: diagnostics.
//
// Native equivalent of the reference's compiled runtime TU
// (src/lib.cpp: colored assertion reporting, deduplicated log-file registry,
// RAII chronometer).  Exposed as a C ABI consumed from Python via ctypes.
//
// Build: see cpp/Makefile (g++ -O2 -shared -fPIC).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <map>
#include <memory>
#include <mutex>
#include <string>

// ---------------------------------------------------------------------------
// diagnostics: log registry + chronometer + failure reporting
// ---------------------------------------------------------------------------

namespace {

struct LogRegistry {
  std::mutex mu;
  std::map<std::string, std::FILE*> files;

  std::FILE* get(const char* path) {
    std::lock_guard<std::mutex> lock(mu);
    auto it = files.find(path);
    if (it != files.end()) return it->second;
    std::FILE* f = std::fopen(path, "a");
    if (f == nullptr) f = stderr;
    files.emplace(path, f);
    return f;
  }
};

LogRegistry& registry() {
  static LogRegistry r;
  return r;
}

struct Chrono {
  std::string message;
  std::string path;
  std::chrono::steady_clock::time_point start;
};

std::mutex chrono_mu;
std::map<int64_t, std::unique_ptr<Chrono>> chronos;
int64_t next_chrono_id = 1;

}  // namespace

extern "C" {

// deduplicated append-only logging (== log_file_t, lib.cpp:181-204)
void ddp_log(const char* path, const char* msg) {
  std::FILE* f = registry().get(path);
  std::fputs(msg, f);
  std::fputc('\n', f);
  std::fflush(f);
}

// RAII-style chronometer handles (== chronometer_t, lib.cpp:206-222)
int64_t ddp_chrono_start(const char* message, const char* path) {
  std::lock_guard<std::mutex> lock(chrono_mu);
  int64_t id = next_chrono_id++;
  auto c = std::make_unique<Chrono>();
  c->message = message;
  c->path = path;
  c->start = std::chrono::steady_clock::now();
  chronos.emplace(id, std::move(c));
  return id;
}

double ddp_chrono_stop(int64_t id) {
  std::unique_ptr<Chrono> c;
  {
    std::lock_guard<std::mutex> lock(chrono_mu);
    auto it = chronos.find(id);
    if (it == chronos.end()) return -1.0;
    c = std::move(it->second);
    chronos.erase(it);
  }
  auto dt = std::chrono::duration<double>(std::chrono::steady_clock::now() - c->start).count();
  std::FILE* f = registry().get(c->path.c_str());
  std::fprintf(f, "done [%s] in %.3f ms\n", c->message.c_str(), dt * 1e3);
  std::fflush(f);
  return dt;
}

// colored failure report (== on_assert_fail, lib.cpp:45-110; returns instead
// of std::terminate so the Python side owns control flow)
void ddp_report_failure(const char* kind, const char* expr, const char* file, int line,
                        const char* message) {
  std::fprintf(stderr,
               "\x1b[1;31m%s failed:\x1b[0m \x1b[1m%s\x1b[0m\n"
               "  at %s:%d\n"
               "  %s\n",
               kind, expr, file, line, message);
  std::fflush(stderr);
}

}  // extern "C"
