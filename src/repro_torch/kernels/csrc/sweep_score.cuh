// The packed arbitration score, shared by the arbiter kernel and the
// tick-loop megakernel. Field constants come from the generated
// sweep_fields.h (single source: repro_torch/core/sweep/fields.py).
#pragma once
#include "sweep_fields.h"

// Priority of an ELIGIBLE head request at tick t (descending fields:
// drain-mode write, occupancy, row hit, no sibling-subarray refresh,
// age). Eligibility (has-request, bank free, head subarray not
// refreshing, rank not draining) is the caller's: an ineligible slot
// scores -1. The age difference is taken in unsigned arithmetic so that
// a never-read garbage arrival cannot overflow a signed subtraction.
__device__ __forceinline__ int arbiter_score(int t, bool drain_write,
                                             int occ, bool hit,
                                             bool mid_ref, int arrive) {
  int age = (int)((unsigned)t - (unsigned)arrive);
  if (age > AGE_CAP) age = AGE_CAP;
  if (occ > OCC_CAP) occ = OCC_CAP;
  return (drain_write ? W_WRITE : 0) + W_OCC * occ + (hit ? W_HIT : 0) +
         (mid_ref ? 0 : W_NOCONF) + age;
}
