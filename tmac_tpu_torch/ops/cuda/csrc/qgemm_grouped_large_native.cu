// K4L's native instances (the reference's act="native": bf16 x times the
// codes on the bf16 tensor cores, f32 sums a fold chunk), both scale
// dtypes: qgemm_grouped_large.cu compiled with TMAC_K4L_NATIVE set, a
// library of its own built beside the other two, so its instances compile
// in parallel with theirs.

#define TMAC_K4L_NATIVE 1
#include "qgemm_grouped_large.cu"
