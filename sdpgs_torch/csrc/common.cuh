// Shared declarations of the sdpgs_torch kernels: a plain C interface,
// loaded from Python with ctypes. Every launcher returns the cudaError_t
// of its launch (0 = success); it never synchronises.
#pragma once

#include <cuda_runtime.h>

#define SDPGS_API extern "C" __attribute__((visibility("default")))

// Payload row gathered by the compositor (rasterizer.py layout):
// mean2d xy, conic abc, opacity*valid, rgb, depth, feature xyz.
constexpr int SDPGS_NPAY = 13;
// Composited channels: rgb, depth, feature xyz.
constexpr int SDPGS_NCH = 7;
