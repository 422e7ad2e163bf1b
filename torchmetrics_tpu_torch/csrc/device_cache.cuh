// Per-device attributes and per-kernel occupancy, queried once and kept, for the port's kernels.
//
// A wrapper call must not pay for device queries that give the same answer every time: the SM
// count, the opt-in shared-memory size, the blocks of a kernel that fit on an SM, and the
// kernel's dynamic shared-memory limit are read or set on the first call for a device (and
// kernel) and cached here. A mutex guards the caches; ctypes calls hold the GIL anyway.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace tm_cache {

constexpr int kMaxDevices = 64;

struct Device {
  int sms = 0;
  int smem_optin = 0;  // bytes of shared memory one block may use after opting in
};

inline std::mutex& guard() {
  static std::mutex m;
  return m;
}

// Makes `index` the current device (only when it is not) and returns its cached attributes.
inline cudaError_t device(int index, Device* out) {
  if (index < 0 || index >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != index && (err = cudaSetDevice(index)) != cudaSuccess) return err;
  static Device devices[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  std::lock_guard<std::mutex> lock(guard());
  if (!ready[index]) {
    Device d;
    if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, index)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, index);
    if (err != cudaSuccess) return err;
    devices[index] = d;
    ready[index] = true;
  }
  *out = devices[index];
  return cudaSuccess;
}

// Blocks of `kernel` resident on one SM of the current device `index` at `threads` threads and
// `smem` bytes of dynamic shared memory. The first call for a (device, kernel) pair also lifts the
// kernel's dynamic shared-memory limit to the opt-in size less the kernel's static shared memory
// (the two together may not exceed it), so a launch above 48 KB is allowed.
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, int index, const Device& dev, int threads, size_t smem, int* out) {
  static std::map<std::pair<int, const void*>, bool> opted_in;
  static std::map<std::pair<std::pair<int, const void*>, size_t>, int> resident;
  const auto fn = std::make_pair(index, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> lock(guard());
  const auto key = std::make_pair(fn, smem);
  const auto hit = resident.find(key);
  if (hit != resident.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  cudaError_t err;
  if (!opted_in[fn]) {
    cudaFuncAttributes attrs;
    if ((err = cudaFuncGetAttributes(&attrs, kernel)) != cudaSuccess) return err;
    const int dynamic = dev.smem_optin - static_cast<int>(attrs.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return err;
    opted_in[fn] = true;
  }
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess) return err;
  *out = resident[key] = per_sm > 0 ? per_sm : 1;
  return cudaSuccess;
}

}  // namespace tm_cache
