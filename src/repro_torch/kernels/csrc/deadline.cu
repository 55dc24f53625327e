// The deadline pair of the overlap harness's collective-latency injection
// (kernels/deadline.py), for sm_90a.
//
// It replaces no TPU kernel: the JAX package stamps and gates its injected
// latency with a pair of ``jax.pure_callback``s on the host
// (repro/core/chaos.py: ``delay_start``, ``delay_gate``).  On the card a
// host stamp would mark when a gradient's kernels were ENQUEUED, since the
// host runs ahead of the asynchronous device; these two kernels read the
// device's own clock (%globaltimer, ns) at the point of the stream where
// the gradient exists, so stream order pins the stamp into the backward
// walk and the gate at the consumer.
//
//   stamp: token = (now - epoch_ns) / 1e6 + delay_ms, an f32 of ms since
//          the host process's epoch (the calibration in deadline.py ties
//          epoch_ns to it), rounded up so a gate never sleeps less than
//          the delay; the raw reading goes to *slot when one is given.
//   gate:  spins with __nanosleep until %globaltimer passes the token's
//          deadline (capped at cap_ms past the gate's start when cap_ms >=
//          0), then writes its start and end readings to slots[0..1] when
//          given.
//
// One thread each: the work is a clock read and a spin, bound by neither
// bytes nor operations.  The gate's spin holds the stream, which is the
// point: the device time it takes is the modelled wire time left over.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void deadline_stamp_kernel(float* token, long long* slot,
                                      long long epoch_ns, float delay_ms) {
  const long long now = global_ns();
  if (token != nullptr) {
    const double ms = static_cast<double>(now - epoch_ns) * 1e-6 +
                      static_cast<double>(delay_ms);
    *token = __double2float_ru(ms);
  }
  if (slot != nullptr) *slot = now;
}

__global__ void deadline_gate_kernel(const float* token, long long* slots,
                                     long long epoch_ns, float cap_ms) {
  const long long start = global_ns();
  long long deadline =
      epoch_ns + static_cast<long long>(ceil(static_cast<double>(*token) *
                                             1e6));
  if (cap_ms >= 0.0f) {
    const long long cap =
        start + static_cast<long long>(ceil(static_cast<double>(cap_ms) *
                                            1e6));
    if (cap < deadline) deadline = cap;
  }
  long long now = start;
  while (now < deadline) {
    // short naps near the deadline: __nanosleep sleeps up to twice its
    // argument, so the overshoot stays under a microsecond or two
    __nanosleep(deadline - now > 20000 ? 4000u : 250u);
    now = global_ns();
  }
  if (slots != nullptr) {
    slots[0] = start;
    slots[1] = now;
  }
}

}  // namespace

extern "C" int repro_deadline_stamp(void* token, void* slot,
                                    long long epoch_ns, float delay_ms,
                                    void* stream) {
  deadline_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(token), static_cast<long long*>(slot), epoch_ns,
      delay_ms);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_deadline_gate(const void* token, void* slots,
                                   long long epoch_ns, float cap_ms,
                                   void* stream) {
  deadline_gate_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(token), static_cast<long long*>(slots),
      epoch_ns, cap_ms);
  return static_cast<int>(cudaGetLastError());
}
