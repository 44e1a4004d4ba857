// Native threaded ray-batch sampler — the host-side data hot path.
//
// The TPU-native stand-in for the reference's native data machinery (the
// torch DataLoader's 8 worker processes, nerfacto/train.py:152-156, and the
// MipNeRF360 producer thread's numpy fancy-indexing,
// internal/datasets.py:446-529). Per training step this samples dilated
// pixel patches across images and gathers rgb / static-mask / near / far
// values into flat batch buffers with a work-stealing thread pool, so the
// Python side only does the (vectorized) ray casting.
//
// C ABI only (consumed via ctypes; pybind11 is not vendored in this image).
// Determinism: a per-call seed drives a PCG32 stream per patch, so batches
// are reproducible regardless of thread scheduling.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  const float* rgb;    // [h, w, 3]
  const float* mask;   // [h, w, 1]
  const float* near;   // [h, w, 1]
  const float* far;    // [h, w, 1]
  int32_t height;
  int32_t width;
  int32_t embed_idx;
};

struct Scene {
  std::vector<Image> images;
};

// PCG32 (O'Neill): tiny, fast, reproducible across platforms.
struct Pcg32 {
  uint64_t state;
  uint64_t inc;
  explicit Pcg32(uint64_t seed, uint64_t seq = 0xda3e39cb94b95bdbULL) {
    state = 0u;
    inc = (seq << 1u) | 1u;
    next();
    state += seed;
    next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + inc;
    uint32_t xorshifted = static_cast<uint32_t>(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = static_cast<uint32_t>(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
  }
  // Unbiased bounded integer (Lemire).
  uint32_t bounded(uint32_t bound) {
    uint64_t m = static_cast<uint64_t>(next()) * bound;
    uint32_t lo = static_cast<uint32_t>(m);
    if (lo < bound) {
      uint32_t t = (-bound) % bound;
      while (lo < t) {
        m = static_cast<uint64_t>(next()) * bound;
        lo = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }
};

}  // namespace

extern "C" {

Scene* rs_create_scene() { return new Scene(); }

void rs_destroy_scene(Scene* scene) { delete scene; }

void rs_add_image(Scene* scene, const float* rgb, const float* mask,
                  const float* near, const float* far, int32_t height,
                  int32_t width, int32_t embed_idx) {
  scene->images.push_back({rgb, mask, near, far, height, width, embed_idx});
}

int32_t rs_num_images(const Scene* scene) {
  return static_cast<int32_t>(scene->images.size());
}

// Sample `n_patches` dilated patches of patch_size^2 pixels from
// `image_num_per_batch` randomly chosen images (contiguous patch runs per
// image, matching the reference's per-image concatenation). Outputs are flat
// [n_rays = n_patches * patch_size^2] arrays.
//
// half_image != 0 restricts x sampling to the left half (the Phototourism
// finetune protocol, datasets.py:512).
//
// Returns 0 on success, negative on bad arguments.
int32_t rs_sample_batch(const Scene* scene, uint64_t seed, int32_t n_patches,
                        int32_t patch_size, int32_t patch_dilation,
                        int32_t image_num_per_batch, int32_t half_image,
                        int32_t num_threads,
                        int32_t* out_pix_x, int32_t* out_pix_y,
                        int32_t* out_cam_idx, int32_t* out_embed_idx,
                        float* out_rgb, float* out_mask, float* out_near,
                        float* out_far) {
  const int32_t n_images = static_cast<int32_t>(scene->images.size());
  if (n_images == 0 || n_patches <= 0 || patch_size <= 0 ||
      image_num_per_batch <= 0) {
    return -1;
  }
  const int32_t p = patch_size;
  const int32_t rays_per_patch = p * p;
  const int32_t patches_per_image = n_patches / image_num_per_batch;
  if (patches_per_image <= 0) return -2;

  // Pick the images up front (sequential RNG: reproducible).
  Pcg32 img_rng(seed, /*seq=*/1);
  std::vector<int32_t> cam_for_patch(n_patches);
  for (int32_t g = 0; g < image_num_per_batch; ++g) {
    int32_t cam = static_cast<int32_t>(img_rng.bounded(n_images));
    for (int32_t k = 0; k < patches_per_image; ++k) {
      cam_for_patch[g * patches_per_image + k] = cam;
    }
  }

  std::atomic<int32_t> next_patch{0};
  std::atomic<bool> degenerate{false};
  auto worker = [&]() {
    for (;;) {
      const int32_t patch = next_patch.fetch_add(1);
      if (patch >= n_patches) break;
      const Image& im = scene->images[cam_for_patch[patch]];
      const int32_t span = (p - 1) * patch_dilation;
      int32_t max_x = (half_image ? im.width / 2 : im.width) - span;
      int32_t max_y = im.height - span;
      if (max_x <= 0 || max_y <= 0) {
        // Patch does not fit this image: outputs for it would be
        // uninitialized garbage. Flag it so the caller raises instead of
        // silently training on junk (the numpy fallback raises too).
        degenerate.store(true, std::memory_order_relaxed);
        continue;
      }
      Pcg32 rng(seed ^ (0x9e3779b97f4a7c15ULL * (patch + 1)), /*seq=*/2);
      const int32_t x0 = static_cast<int32_t>(rng.bounded(max_x));
      const int32_t y0 = static_cast<int32_t>(rng.bounded(max_y));

      float* rgb_out = out_rgb + static_cast<int64_t>(patch) * rays_per_patch * 3;
      const int64_t base = static_cast<int64_t>(patch) * rays_per_patch;
      for (int32_t dy = 0; dy < p; ++dy) {
        const int32_t y = y0 + dy * patch_dilation;
        for (int32_t dx = 0; dx < p; ++dx) {
          const int32_t x = x0 + dx * patch_dilation;
          const int64_t ray = base + dy * p + dx;
          const int64_t pix = static_cast<int64_t>(y) * im.width + x;
          out_pix_x[ray] = x;
          out_pix_y[ray] = y;
          out_cam_idx[ray] = cam_for_patch[patch];
          out_embed_idx[ray] = im.embed_idx;
          std::memcpy(rgb_out + (dy * p + dx) * 3, im.rgb + pix * 3,
                      3 * sizeof(float));
          out_mask[ray] = im.mask[pix];
          out_near[ray] = im.near[pix];
          out_far[ray] = im.far[pix];
        }
      }
    }
  };

  int32_t n_threads = num_threads > 0 ? num_threads : 4;
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return degenerate.load(std::memory_order_relaxed) ? -3 : 0;
}

}  // extern "C"
