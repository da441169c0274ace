// Launch helpers shared by the kernel sources of this directory.
#pragma once

#include <cuda_runtime.h>

namespace scarlet {

// Allows `smem` bytes of dynamic shared memory (needed above 48 KB).
template <typename Kernel>
int set_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

constexpr int kMaxDevices = 64;

// set_smem where a launch needs it (above 48 KB), once per device and
// size: `granted` (kMaxDevices ints, zero at first) is the record of one
// kernel instantiation, so launches skip cudaFuncSetAttribute.
template <typename Kernel>
int grant_smem(Kernel kernel, int smem, int* granted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  const bool known = dev < kMaxDevices;
  if (known && smem <= granted[dev]) return 0;
  err = set_smem(kernel, smem);
  if (err == 0 && known) granted[dev] = smem;
  return err;
}

// What the compiler made of `kernel`: out[0] registers per thread, out[1]
// local (spill) bytes per thread, out[2] blocks resident per SM at
// `threads` and `smem` dynamic shared bytes.  It raises the kernel's
// shared-memory allowance where the query needs it and never lowers it
// (a launch that grant_smem let through must stay valid).
template <typename Kernel>
int kernel_info(Kernel kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err != 0) return err;
  if (smem > attr.maxDynamicSharedSizeBytes) err = set_smem(kernel, smem);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                           threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return err;
}

}  // namespace scarlet
