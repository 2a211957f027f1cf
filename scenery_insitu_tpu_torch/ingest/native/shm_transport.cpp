// Shared-memory frame transport: simulation -> renderer host bridge.
//
// TPU-native re-design of the reference's SysV double-buffer protocol
// (ShmAllocator.cpp / ShmBuffer.cpp / SemManager.cpp — producer writes a
// new timestep into the idle buffer and raises its semaphore; consumer
// attaches, raises its own; producer frees only when the consumer count
// drops; see SURVEY.md §2b "Protocol summary"). Differences, on purpose:
//
//  - POSIX shm_open/mmap + one process-shared semaphore in the control
//    block instead of SysV shmget/semget key juggling (the reference needed
//    ftok key toggling and stuck-semaphore recovery CLIs; names + atomics
//    make states inspectable and crash-robust).
//  - N-slot ring (default 3) generalizing the reference's 2-key toggle: one
//    slot being written, one latest, one held by a reader — the producer
//    NEVER blocks (the reference guaranteed that by falling back to heap
//    malloc, ShmAllocator.cpp:59-96; here acquire just returns the next
//    free slot, or -1 if a slow reader holds everything).
//  - seq numbers instead of semaphore counts: the consumer asks for "a
//    frame newer than the last I saw" (≅ ShmBuffer::update_key(wait),
//    ShmBuffer.cpp:84-112), blocking on the semaphore or polling.
//
// Single producer, multiple readers. The C ABI below is consumed from
// Python via ctypes (scenery_insitu_tpu/ingest/shm.py) and from the demo
// simulation producers in this directory.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <semaphore.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53495456;  // "VTIS"
constexpr uint32_t kMaxSlots = 8;
constexpr size_t kHeaderBytes = 4096;    // control block, page aligned

struct SlotState {
  std::atomic<uint32_t> readers;
  std::atomic<uint64_t> seq;             // 0 = never published
  uint8_t pad[48];                       // avoid false sharing
};

struct Control {
  uint32_t magic;
  uint32_t nslots;
  uint64_t slot_size;
  std::atomic<uint64_t> next_seq;        // last published seq
  std::atomic<int32_t> latest;           // slot index of newest frame, -1
  std::atomic<uint32_t> waiters;
  std::atomic<uint32_t> writer_attached;
  sem_t fresh;                           // posted on publish when waited on
  std::atomic<uint64_t> frames_dropped;  // acquire failures (all slots busy)
  SlotState slots[kMaxSlots];
};

static_assert(sizeof(Control) <= kHeaderBytes, "control block too large");

struct Handle {
  Control* ctl;
  uint8_t* base;
  size_t map_bytes;
  int writing;                           // producer's in-flight slot, -1
  uint64_t last_seen;                    // consumer's newest consumed seq
};

size_t map_size(uint32_t nslots, uint64_t slot_size) {
  return kHeaderBytes + static_cast<size_t>(nslots) * slot_size;
}

Handle* map_channel(const char* name, int oflag, uint32_t nslots,
                    uint64_t slot_size) {
  int fd = shm_open(name, oflag, 0600);
  if (fd < 0) return nullptr;
  bool creating = (oflag & O_CREAT) != 0;
  size_t bytes;
  if (creating) {
    bytes = map_size(nslots, slot_size);
    if (ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < (off_t)kHeaderBytes) {
      close(fd);
      return nullptr;
    }
    bytes = static_cast<size_t>(st.st_size);
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Handle* h = new Handle();
  h->ctl = static_cast<Control*>(mem);
  h->base = static_cast<uint8_t*>(mem) + kHeaderBytes;
  h->map_bytes = bytes;
  h->writing = -1;
  h->last_seen = 0;
  return h;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- producer

// Create (or recreate) a channel. Returns an opaque handle or null.
void* shm_channel_create(const char* name, uint64_t slot_size,
                         uint32_t nslots) {
  if (nslots < 2 || nslots > kMaxSlots || slot_size == 0) return nullptr;
  shm_unlink(name);  // stale channels from crashed runs are superseded
  Handle* h = map_channel(name, O_CREAT | O_EXCL | O_RDWR, nslots, slot_size);
  if (!h) return nullptr;
  Control* c = h->ctl;
  std::memset(static_cast<void*>(c), 0, kHeaderBytes);
  c->nslots = nslots;
  c->slot_size = slot_size;
  c->latest.store(-1, std::memory_order_relaxed);
  sem_init(&c->fresh, /*pshared=*/1, 0);
  c->writer_attached.store(1, std::memory_order_relaxed);
  c->magic = kMagic;  // published last: consumers spin on it
  return h;
}

// Pointer to a writable slot for the next frame, or null if every other
// slot is held by a reader (producer never blocks; the frame is dropped —
// ≅ the reference's heap-malloc fallback keeping its producer lock-free).
void* shm_producer_acquire(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Control* c = h->ctl;
  int latest = c->latest.load(std::memory_order_acquire);
  for (uint32_t i = 0; i < c->nslots; ++i) {
    if (static_cast<int>(i) == latest) continue;  // a reader may grab it next
    if (c->slots[i].readers.load(std::memory_order_acquire) == 0) {
      h->writing = static_cast<int>(i);
      return h->base + static_cast<size_t>(i) * c->slot_size;
    }
  }
  c->frames_dropped.fetch_add(1, std::memory_order_relaxed);
  return nullptr;
}

// Publish the slot last acquired; returns its sequence number.
uint64_t shm_producer_publish(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Control* c = h->ctl;
  if (h->writing < 0) return 0;
  uint64_t seq = c->next_seq.fetch_add(1, std::memory_order_acq_rel) + 1;
  c->slots[h->writing].seq.store(seq, std::memory_order_release);
  c->latest.store(h->writing, std::memory_order_release);
  h->writing = -1;
  if (c->waiters.load(std::memory_order_acquire) > 0) sem_post(&c->fresh);
  return seq;
}

uint64_t shm_channel_frames_dropped(void* handle) {
  return static_cast<Handle*>(handle)
      ->ctl->frames_dropped.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------- consumer

// Open an existing channel; returns null until the producer created it.
void* shm_consumer_open(const char* name) {
  Handle* h = map_channel(name, O_RDWR, 0, 0);
  if (!h) return nullptr;
  if (h->ctl->magic != kMagic) {  // not yet initialized
    munmap(h->ctl, h->map_bytes);
    delete h;
    return nullptr;
  }
  return h;
}

uint64_t shm_channel_slot_size(void* handle) {
  return static_cast<Handle*>(handle)->ctl->slot_size;
}

uint32_t shm_channel_nslots(void* handle) {
  return static_cast<Handle*>(handle)->ctl->nslots;
}

// Acquire the newest frame strictly newer than the consumer's last one.
// timeout_ms: 0 = poll once, <0 = wait forever. On success pins the slot
// (readers++), stores the data pointer + seq, returns slot index; -1 on
// timeout. Release with shm_consumer_release.
int32_t shm_consumer_latest(void* handle, int64_t timeout_ms, void** data,
                            uint64_t* seq_out) {
  Handle* h = static_cast<Handle*>(handle);
  Control* c = h->ctl;
  for (;;) {
    int32_t l = c->latest.load(std::memory_order_acquire);
    if (l >= 0) {
      uint64_t seq = c->slots[l].seq.load(std::memory_order_acquire);
      if (seq > h->last_seen) {
        // pin, then re-verify the slot still carries this frame (the
        // producer skips the latest slot, so a pinned latest is stable,
        // but latest may have moved between the load and the pin)
        c->slots[l].readers.fetch_add(1, std::memory_order_acq_rel);
        if (c->slots[l].seq.load(std::memory_order_acquire) == seq) {
          h->last_seen = seq;
          *data = h->base + static_cast<size_t>(l) * c->slot_size;
          if (seq_out) *seq_out = seq;
          return l;
        }
        c->slots[l].readers.fetch_sub(1, std::memory_order_acq_rel);
        continue;  // raced a publish; retry immediately
      }
    }
    if (timeout_ms == 0) return -1;
    c->waiters.fetch_add(1, std::memory_order_acq_rel);
    int rc;
    if (timeout_ms < 0) {
      rc = sem_wait(&c->fresh);
    } else {
      struct timespec ts;
      clock_gettime(CLOCK_REALTIME, &ts);
      ts.tv_sec += timeout_ms / 1000;
      ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
      if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec += 1;
        ts.tv_nsec -= 1000000000L;
      }
      rc = sem_timedwait(&c->fresh, &ts);
    }
    c->waiters.fetch_sub(1, std::memory_order_acq_rel);
    if (rc != 0 && (errno == ETIMEDOUT)) return -1;
    // EINTR or success: re-check the ring
  }
}

void shm_consumer_release(void* handle, int32_t slot) {
  Handle* h = static_cast<Handle*>(handle);
  if (slot >= 0 && slot < static_cast<int32_t>(h->ctl->nslots))
    h->ctl->slots[slot].readers.fetch_sub(1, std::memory_order_acq_rel);
}

// ------------------------------------------------------- inspect / recover
//
// ≅ the reference's stuck-state debug CLIs sem_get.cpp (print semaphore
// state for a rank) and sem_reset.cpp (zero it to recover a wedged
// protocol). The ring's state is plain atomics in the control block, so
// inspection is a read and recovery is clearing stale reader pins left by
// crashed consumers.

// Fills out[0..7+2*nslots): nslots, slot_size, next_seq, latest(+1, so 0
// means "none"), waiters, writer_attached, frames_dropped, then per slot
// (readers, seq). Returns the number of u64s written, or 0 if out_len is
// too small.
uint32_t shm_channel_stats(void* handle, uint64_t* out, uint32_t out_len) {
  Handle* h = static_cast<Handle*>(handle);
  Control* c = h->ctl;
  uint32_t need = 7 + 2 * c->nslots;
  if (out_len < need) return 0;
  out[0] = c->nslots;
  out[1] = c->slot_size;
  out[2] = c->next_seq.load(std::memory_order_acquire);
  out[3] = static_cast<uint64_t>(c->latest.load(std::memory_order_acquire) + 1);
  out[4] = c->waiters.load(std::memory_order_acquire);
  out[5] = c->writer_attached.load(std::memory_order_acquire);
  out[6] = c->frames_dropped.load(std::memory_order_relaxed);
  for (uint32_t i = 0; i < c->nslots; ++i) {
    out[7 + 2 * i] = c->slots[i].readers.load(std::memory_order_acquire);
    out[8 + 2 * i] = c->slots[i].seq.load(std::memory_order_acquire);
  }
  return need;
}

// Clears all reader pins (crashed consumers leak them, which eventually
// starves shm_producer_acquire). Returns the number of pins cleared.
uint32_t shm_channel_reset_readers(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  Control* c = h->ctl;
  uint32_t cleared = 0;
  for (uint32_t i = 0; i < c->nslots; ++i)
    cleared += c->slots[i].readers.exchange(0, std::memory_order_acq_rel);
  return cleared;
}

// ------------------------------------------------------------------ common

void shm_channel_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h) return;
  munmap(h->ctl, h->map_bytes);
  delete h;
}

int shm_channel_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
