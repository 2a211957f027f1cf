// Standalone simulation producer for transport tests and demos
// (≅ the reference's shm_mpiproducer.cpp: a built-in SHO particle sim used
// as the fake workload driving the shm transport, :85-143 — here with a
// scalar-field mode too, since the TPU renderer's volume path ingests
// grids).
//
// Usage: demo_producer <channel> <mode:field|particles|slab> <size> <frames>
//                      [period_ms=5] [rank=0] [nranks=1]
//   field:     size = grid side; slot = size^3 f32 (travelling Gaussian)
//   particles: size = particle count; slot = size*6 f32 (pos+vel, SHO)
//   slab:      this rank's z-slab [size/nranks, size, size] of the SAME
//              global travelling Gaussian (bit-identical rows to field
//              mode at the same frame) — one process per compute rank,
//              the multi-rank feed of the distributed renderer (≅ the
//              reference's per-rank MPI partners each updating their
//              DistributedVolumeRenderer slab, :136-160)
//
// Exits after <frames> publishes; prints one line per 100 frames.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <thread>
#include <vector>

extern "C" {
void* shm_channel_create(const char* name, uint64_t slot_size,
                         uint32_t nslots);
void* shm_producer_acquire(void* handle);
uint64_t shm_producer_publish(void* handle);
uint64_t shm_channel_frames_dropped(void* handle);
void shm_channel_close(void* handle);
int shm_channel_unlink(const char* name);
}

// One frame of the travelling Gaussian, global rows [z0, z1) of a
// size^3 grid. field mode passes the whole range; slab mode its slab —
// identical arithmetic, so slab frames are bit-equal to field rows.
static void fill_field(float* out, long size, long z0, long z1, long f) {
  const float cx = 0.5f + 0.3f * std::sin(0.05f * f);
  const float cy = 0.5f + 0.3f * std::cos(0.05f * f);
  const float cz = 0.5f;
  for (long z = z0; z < z1; ++z)
    for (long y = 0; y < size; ++y)
      for (long x = 0; x < size; ++x) {
        const float dx = (x + 0.5f) / size - cx;
        const float dy = (y + 0.5f) / size - cy;
        const float dz = (z + 0.5f) / size - cz;
        out[((z - z0) * size + y) * size + x] =
            std::exp(-(dx * dx + dy * dy + dz * dz) / 0.02f);
      }
}

int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s <channel> <field|particles|slab> <size> <frames> "
                 "[period_ms] [rank] [nranks]\n",
                 argv[0]);
    return 2;
  }
  const char* channel = argv[1];
  const bool field_mode = std::strcmp(argv[2], "field") == 0;
  const bool slab_mode = std::strcmp(argv[2], "slab") == 0;
  const long size = std::atol(argv[3]);
  const long frames = std::atol(argv[4]);
  const long period_ms = argc > 5 ? std::atol(argv[5]) : 5;
  const long rank = argc > 6 ? std::atol(argv[6]) : 0;
  const long nranks = argc > 7 ? std::atol(argv[7]) : 1;
  if (slab_mode && (nranks < 1 || size % nranks || rank < 0
                    || rank >= nranks)) {
    std::fprintf(stderr, "slab mode needs 0 <= rank < nranks and "
                 "size %% nranks == 0 (got size=%ld rank=%ld nranks=%ld)\n",
                 size, rank, nranks);
    return 2;
  }
  if (!slab_mode && (rank != 0 || nranks != 1)) {
    std::fprintf(stderr, "rank/nranks are slab-mode args (mode %s would "
                 "silently publish the wrong z-window)\n", argv[2]);
    return 2;
  }
  const long dn = slab_mode ? size / nranks : size;

  const uint64_t slot =
      (field_mode || slab_mode) ? sizeof(float) * dn * size * size
                                : sizeof(float) * size * 6;
  void* h = shm_channel_create(channel, slot, 3);
  if (!h) {
    std::perror("shm_channel_create");
    return 1;
  }

  // SHO particle state (positions in [0,1), omega^2 = 4 about the center —
  // same toy dynamics the reference's producer used)
  const bool grid_mode = field_mode || slab_mode;
  std::vector<float> pos(grid_mode ? 0 : size * 3),
      vel(grid_mode ? 0 : size * 3);
  for (long i = 0; i < (long)pos.size(); ++i) {
    pos[i] = static_cast<float>((i * 2654435761u % 1000) / 1000.0);
    vel[i] = 0.0f;
  }

  const float dt = 0.005f, omega2 = 4.0f;
  for (long f = 0; f < frames; ++f) {
    float* out = static_cast<float*>(shm_producer_acquire(h));
    if (out) {
      if (grid_mode) {
        // travelling Gaussian blob: analytic, cheap, visibly animated
        fill_field(out, size, rank * dn, (rank + 1) * dn, f);
      } else {
        for (long i = 0; i < size * 3; ++i) {
          const float acc = -omega2 * (pos[i] - 0.5f);
          vel[i] += dt * acc;
          pos[i] += dt * vel[i];
        }
        std::memcpy(out, pos.data(), pos.size() * sizeof(float));
        std::memcpy(out + size * 3, vel.data(), vel.size() * sizeof(float));
      }
      shm_producer_publish(h);
    }
    if (f % 100 == 0)
      std::printf("produced %ld/%ld (dropped %llu)\n", f, frames,
                  (unsigned long long)shm_channel_frames_dropped(h));
    if (period_ms > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(period_ms));
  }
  std::printf("done: %ld frames, dropped %llu\n", frames,
              (unsigned long long)shm_channel_frames_dropped(h));
  shm_channel_close(h);
  return 0;
}
