// C API of the keystone_tpu native kernel library: the port's own copy of
// keystone_tpu/native/src/keystone_native.h, changed in comments only.
//
// TPU-native rebuild of the reference's non-JVM layer (SURVEY.md §2.3):
// the JNI-wrapped VLFeat dense SIFT and the EncEval GMM/Fisher-Vector
// toolkit become a self-contained C++ library exposed through a plain C
// ABI for ctypes (no pybind11 in this environment). Clean-room
// implementations — no reference code was available or used.
//
// Ref (interface parity targets, [unverified]):
//   utils.external.VLFeat.getSIFTs          -> ks_dense_sift
//   utils.external.EncEval.computeGMM       -> ks_gmm_fit
//   utils.external.EncEval.calcAndGetFVs    -> ks_fisher_vector
//
// All matrices are row-major float32. Every function returns 0 on success,
// negative on argument errors.

#ifndef KEYSTONE_NATIVE_H_
#define KEYSTONE_NATIVE_H_

#include <cstdint>

extern "C" {

// Number of dense-grid keypoints for an (h, w) image with the given step
// and spatial bin size (descriptor support is 4 bins => 4*bin_size px).
int ks_sift_num_keypoints(int h, int w, int step, int bin_size);

// Dense SIFT over a batch of grayscale images.
//   images: (n, h, w) in [0, 1]
//   out:    (n, num_keypoints, 128)
// Descriptors: 4x4 spatial bins x 8 orientation bins, bilinear soft
// binning, Gaussian spatial weighting, L2 -> 0.2 clamp -> re-L2.
int ks_dense_sift(const float* images, int n, int h, int w, int step,
                  int bin_size, float* out);

// Diagonal-covariance GMM fit by EM (k-means++-style seeded).
//   X: (n, d); out: weights (k), means (k, d), vars (k, d)
int ks_gmm_fit(const float* X, int n, int d, int k, int iters,
               std::uint64_t seed, float* weights, float* means, float* vars);

// Fisher-vector encoding of a descriptor set against a fitted GMM.
//   X: (n, d); out: (2*k*d) — mean gradients then variance gradients.
// Raw (un-normalized) FV; signed-sqrt/L2 are pipeline nodes downstream.
int ks_fisher_vector(const float* X, int n, int d, const float* weights,
                     const float* means, const float* vars, int k,
                     float* out);

// Parallel JPEG decode pool: n images -> RGB float32 NHWC at (size, size),
// values scaled to [0, 1]. The ingest-side replacement for a Python-thread
// PIL pool (SURVEY.md §7 hard part 4): libjpeg DCT-scaled decode + bilinear
// resize, OpenMP across images, no GIL anywhere.
//   data:    concatenation of all jpeg byte streams
//   offsets: (n+1) prefix offsets into data (offsets[0] == 0)
//   out:     (n, size, size, 3) float32
// Returns 0, or -(i+1) where i is the first image that failed to decode.
int ks_decode_jpeg_batch(const std::uint8_t* data,
                         const std::uint64_t* offsets, int n, int size,
                         float* out);

// Library ABI version (bump on struct/signature changes).
int ks_abi_version();

}  // extern "C"

#endif  // KEYSTONE_NATIVE_H_
