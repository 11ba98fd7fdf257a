// Concurrency stress harness for the arena allocator, built under
// ASAN/TSAN (see Makefile).
//
// Reference parity: upstream runs its C++ core under --config=asan /
// --config=tsan bazel CI jobs (SURVEY.md §4 sanitizers row, §5.2);
// this is the equivalent discipline for the one native component here.
//
// The arena's contract: ONE owner process allocates/frees (possibly
// from several threads — raylet reader threads free pins concurrently
// with scheduler-thread allocs) while the process-shared robust mutex
// serializes mutation.  The stress spawns N threads doing random
// alloc/write/verify/free cycles over a small arena (high contention +
// frequent exhaustion), then checks zero corruption, zero leaked
// bytes, and an intact header.  (Full single-run coalescing is NOT
// asserted: arena.cc coalesces forward-only, so a drained arena may
// legitimately end as several free runs.)

#include <pthread.h>
#include <sched.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

extern "C" {
int arena_init(uint8_t* base, uint64_t capacity);
int arena_check(uint8_t* base);
uint64_t arena_alloc(uint8_t* base, uint64_t size);  // 0 = exhausted
int arena_free(uint8_t* base, uint64_t payload_off);
uint64_t arena_bytes_in_use(uint8_t* base);
}

static const int kThreads = 8;
static const int kIters = 20000;
static const uint64_t kCapacity = 1 << 20;  // 1 MB: constant pressure

struct Ctx {
  uint8_t* base;
  unsigned seed;
  long allocs = 0, fails = 0, corrupt = 0;
};

static void* worker(void* arg) {
  Ctx* ctx = static_cast<Ctx*>(arg);
  const int kHold = 48;                 // blocks held concurrently
  uint64_t offs[kHold];
  uint64_t sizes[kHold];
  int held = 0;
  for (int i = 0; i < kIters; i++) {
    bool do_alloc = held == 0 ||
        (held < kHold && (rand_r(&ctx->seed) & 1));
    if (do_alloc) {
      uint64_t size = 64 + rand_r(&ctx->seed) % 16384;
      uint64_t off = arena_alloc(ctx->base, size);
      if (off == 0) {
        ctx->fails++;       // exhaustion under contention is expected
        continue;
      }
      ctx->allocs++;
      memset(ctx->base + off, (unsigned char)((off ^ size) | 1), size);
      offs[held] = off;
      sizes[held] = size;
      held++;
      if ((i & 15) == 0) sched_yield();
    } else {
      int pick = rand_r(&ctx->seed) % held;
      uint64_t off = offs[pick], size = sizes[pick];
      unsigned char tag = (unsigned char)((off ^ size) | 1);
      for (uint64_t j = 0; j < size; j += 257) {
        if (ctx->base[off + j] != tag) {
          ctx->corrupt++;   // another thread's block overlapped ours
          break;
        }
      }
      if (arena_free(ctx->base, off) != 0) ctx->corrupt++;
      offs[pick] = offs[held - 1];
      sizes[pick] = sizes[held - 1];
      held--;
    }
  }
  while (held > 0) {                    // drain: leak check must be 0
    held--;
    if (arena_free(ctx->base, offs[held]) != 0) ctx->corrupt++;
  }
  return nullptr;
}

int main() {
  uint8_t* base = static_cast<uint8_t*>(aligned_alloc(64, kCapacity));
  if (base == nullptr) {
    fprintf(stderr, "aligned_alloc failed (environment, not arena)\n");
    return 2;
  }
  if (arena_init(base, kCapacity) != 0) {
    fprintf(stderr, "arena_init failed\n");
    return 2;
  }
  pthread_t threads[kThreads];
  Ctx ctxs[kThreads];
  for (int t = 0; t < kThreads; t++) {
    ctxs[t].base = base;
    ctxs[t].seed = 1234u + t;
    pthread_create(&threads[t], nullptr, worker, &ctxs[t]);
  }
  long allocs = 0, fails = 0, corrupt = 0;
  for (int t = 0; t < kThreads; t++) {
    pthread_join(threads[t], nullptr);
    allocs += ctxs[t].allocs;
    fails += ctxs[t].fails;
    corrupt += ctxs[t].corrupt;
  }
  uint64_t leaked = arena_bytes_in_use(base);
  int magic_ok = arena_check(base);
  free(base);
  printf("allocs=%ld exhaustions=%ld corruptions=%ld leaked=%llu\n",
         allocs, fails, corrupt, (unsigned long long)leaked);
  if (corrupt != 0 || leaked != 0 || magic_ok != 0) {
    fprintf(stderr, "STRESS FAILED\n");
    return 1;
  }
  printf("ARENA STRESS PASSED\n");
  return 0;
}
