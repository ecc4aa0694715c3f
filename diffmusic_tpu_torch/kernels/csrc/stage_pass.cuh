// The bf16 stage backward's passes on the conv1d kernel's TMA + wgmma core
// (conv1d.cu, namespace tc), which stage_bwd.cu launches: one launch runs
// one adjoint conv of one pair in each of up to MAX_BRANCHES branches, block
// z = slot * B + batch, each slot reading its own input and weight through
// its own tensor maps and writing its own outputs.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace dm {
namespace stage_pass {

constexpr int MAX_BRANCHES = 4;

// The two epilogues (the forward's bias / residual epilogue is the third):
//   MASK:     out = leaky'(sign) * acc, bf16 (the stage's dh);
//   MASK_ACC: v = leaky'(sign) * acc + dcur_old, fp32, written to dcur and,
//             where `out` is not null, rounded to bf16 into out (the next
//             pair's operand); dcur_old is dcur itself, or g * inv where g is
//             not null (a branch's first pair: dcur_0 = g / n_branches).
// Rows outside [sig0, sig1) are written as exact zeros in every output.
enum Epilogue { MASK = 1, MASK_ACC = 2 };

struct Args {
  CUtensorMap a[MAX_BRANCHES];              // the slot's input (B, T, C) rows (encode_rows)
  CUtensorMap w[MAX_BRANCHES];              // its weight (k, C, C) as it lies, read flipped
  const __nv_bfloat16* sign[MAX_BRANCHES];  // h_i (MASK) or x_i (MASK_ACC)
  __nv_bfloat16* out[MAX_BRANCHES];
  float* dcur[MAX_BRANCHES];                // MASK_ACC only
  const __nv_bfloat16* g[MAX_BRANCHES];     // MASK_ACC only, or null
  int k[MAX_BRANCHES], dil[MAX_BRANCHES];
  int slots;
  float inv;
};

// Host side, defined in conv1d.cu. Each returns a cudaError_t (0 = done).
// The tensor map of a (B, T, C) bf16 activation as the pass reads it.
int encode_rows(CUtensorMap* map, const void* base, int B, int Tlen, int C);
// Launches one pass of epilogue `epi` for a.slots slots on the stream.
int launch(const Args& a, int epi, int B, int Tlen, int C, float slope, int sig0, int sig1,
           cudaStream_t s);
// Dynamic shared memory of one block.
size_t smem();

}  // namespace stage_pass
}  // namespace dm
