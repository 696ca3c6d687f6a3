// Shared declarations of the sdpgs_torch kernels: a plain C interface,
// loaded from Python with ctypes. Every launcher returns the cudaError_t
// of its launch (0 = success); it never synchronises.
#pragma once

#include <cuda_runtime.h>

#define SDPGS_API extern "C" __attribute__((visibility("default")))
// Per-element math shared by a forward kernel and its backward.
#define SDPGS_DEVICE __device__ __forceinline__

// Payload row gathered by the compositor (ops/rasterize/payload.py's column
// map): mean2d xy, conic abc, opacity*valid, rgb, depth, feature xyz.
constexpr int SDPGS_NPAY = 13;
constexpr int SDPGS_PAY_MEAN2D = 0;
constexpr int SDPGS_PAY_CONIC = 2;
constexpr int SDPGS_PAY_OPACITY = 5;
constexpr int SDPGS_PAY_RGB = 6;
constexpr int SDPGS_PAY_DEPTH = 9;
constexpr int SDPGS_PAY_FEATURE = 10;
// Composited channels: rgb, depth, feature xyz.
constexpr int SDPGS_NCH = 7;
