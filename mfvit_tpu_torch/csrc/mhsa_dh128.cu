// K12-K14's attention core (mhsa.cuh) at head_dim 128, in a translation
// unit of its own so that the builds of the head_dims run in parallel.
#include "mhsa.cuh"

int mhsa::run_dh128(const Args& a, int variant, const Plan& pl, cudaStream_t s) {
  return launch_variant<128>(a, variant, pl, s);
}
