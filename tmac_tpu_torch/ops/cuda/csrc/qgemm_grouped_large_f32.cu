// K4L's instances for f32 scales and zero points (GGUF's block scales):
// qgemm_grouped_large.cu compiled with TMAC_K4L_F32 set, a library of its
// own built beside the bf16 one (build.py), so the two halves of K4L's
// template instances compile in parallel.

#define TMAC_K4L_F32 1
#include "qgemm_grouped_large.cu"
