// Device stamps: the card's %globaltimer written into a ring of rows on the
// card, one row a stamped run of a captured program (a streamed megastep),
// one slot a tag.
//
// Not a TPU kernel, and no port of an XLA fusion: an instrument. A CUDA
// event recorded inside a graph is recorded again on every replay, so
// reading it per frame would need a synchronize after each frame; a stamp
// node writes the time where the host can fetch it later without waiting
// (`ctrlvio_tpu_torch/utils/spans.py::StampRing`). The plain version,
// `ctrlvio_tpu_torch/ops/stamp.py::stamp_plain`, does the same with the
// host's `time.time_ns()`.
//
// A row (int64 slots): [SEQ, N_TRIPS, tags..., trips...].
//   START: the row of the ring's head (head % rows) is zeroed, SEQ = head,
//          then the tag's slot takes the time;
//   MARK:  the tag's slot takes the time;
//   TRIP:  slot `slot + N_TRIPS` takes the time (while inside the row) and
//          N_TRIPS grows by one: one stamp each trip of a WHILE node, so
//          the row counts the trips its run made;
//   END:   the tag's slot takes the time and the head moves on.
// Two kernels of one body, so that a trace tells the rings apart by name:
// `stamp_kernel` (kind 0, the streamed megastep's ring) and
// `stamp_frontend` (kind 1, the front end's step).
// One thread, one launch a stamp on the caller's stream: nothing bounds it
// but the launch (a graph node, ~1-2 us). %globaltimer counts ns on the
// card's own clock; `spans.Clock` maps it onto the host's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { SEQ = 0, N_TRIPS = 1 };
enum { START = 0, MARK = 1, TRIP = 2, END = 3 };

__device__ __forceinline__ void write_stamp(long long* ring, long long* head,
                                            long long rows, int slots,
                                            int slot, int mode) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long h = *head;
  long long* row = ring + (h % rows) * slots;
  if (mode == START) {
    for (int i = 0; i < slots; ++i) row[i] = 0;
    row[SEQ] = h;
  }
  if (mode == TRIP) {
    const long long k = row[N_TRIPS];
    if (slot + k < slots) row[slot + k] = (long long)t;
    row[N_TRIPS] = k + 1;
  } else {
    row[slot] = (long long)t;
  }
  if (mode == END) *head = h + 1;
}

__global__ void stamp_kernel(long long* ring, long long* head,
                             long long rows, int slots, int slot,
                             int mode) {
  write_stamp(ring, head, rows, slots, slot, mode);
}

__global__ void stamp_frontend(long long* ring, long long* head,
                               long long rows, int slots, int slot,
                               int mode) {
  write_stamp(ring, head, rows, slots, slot, mode);
}

}  // namespace

extern "C" int stamp(void* ring, void* head, long long rows, int slots,
                     int slot, int mode, int kind, void* stream) {
  if (rows < 1 || slot < 0 || slot >= slots || mode < START || mode > END ||
      kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = kind == 0 ? stamp_kernel : stamp_frontend;
  kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)head, rows, slots, slot, mode);
  return (int)cudaGetLastError();
}
