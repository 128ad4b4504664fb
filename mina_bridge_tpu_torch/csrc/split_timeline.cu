// The timeline of K3's bucket weighting and K5's lane repair, for
// scripts/torch_weight_sweep.py --timeline; no path calls it.
//
// The kernels run the programs of points.cuh (split::weight_grid,
// split::lane_scan) that padd_weight_sum_kernel and
// padd_select_scan_kernel run, on Pallas's base field, and record for
// every unit of the weighting (every block of the repair) its SM, the
// %globaltimer (ns) at its start and at the end of each of its steps
// (stamps 0-4, 0 where it has no such step) and the block that ran it, 8
// words each in rec; the weighting's grid-wide levels' ends follow (block
// 0's stamps).
#include <cuda_runtime.h>

#include "points.cuh"

namespace {

namespace split = pts::split;

__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

struct Stamps {
  unsigned long long* rec;  // 8 words a unit
  __host__ __device__ void operator()(int k, int u) const {
#ifdef __CUDA_ARCH__
    if (threadIdx.x != 0) return;
    unsigned long long* r = rec + 8 * (int64_t)u;
    if (k < 0) {
      r[0] = sm_id();
      r[7] = blockIdx.x;
    }
    r[2 + k] = now();
#endif
  }
};

__global__ void __launch_bounds__(split::THREADS, 2)
    weight_timeline_kernel(const int64_t* buckets, int64_t* out, uint64_t* roots, int W, int D, int K, int C,
                           unsigned long long* rec) {
  extern __shared__ uint64_t smem[];
  split::weight_grid<0>(split::GridBlock{smem}, buckets, out, roots, W, D, K, C, Stamps{rec});
}

__global__ void __launch_bounds__(split::THREADS, 2)
    lane_timeline_kernel(const int64_t* carry, const int32_t* has_start, int64_t* out, uint64_t* scratch, int W,
                         int G, int CL, unsigned long long* rec) {
  extern __shared__ uint64_t smem[];
  split::lane_scan<0>(split::ClusterBlock{smem, CL}, carry, has_start, out, scratch, W, G, Stamps{rec});
}

}  // namespace

// kind 0: the weighting (in: buckets (3, 22, W, n + 1), work: the chunk
// roots' scratch, K chunks, C a unit, a cooperative launch of `blocks`
// blocks); kind 1: the repair (in: carry (3, 22, W, n), flags, work:
// scratch or null). out as the kernels'; rec: 8 words a unit (W K / C) or
// block (W lane_cluster(n)), then the weighting's level rows, zero.
extern "C" int mbt_split_timeline(int kind, const int64_t* in, const int32_t* flags, int64_t* out, void* work,
                                  int64_t W, int64_t n, int64_t K, int64_t C, int64_t blocks, void* rec,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  auto* r = (unsigned long long*)rec;
  if (kind == 0) {
    const size_t smem = split::weight_bytes((int)(n / K), (int)C);
    cudaFuncSetAttribute(weight_timeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int w = (int)W, d = (int)n, k = (int)K, c = (int)C;
    void* args[] = {(void*)&in, (void*)&out, &work, &w, &d, &k, &c, (void*)&r};
    cudaLaunchCooperativeKernel((const void*)weight_timeline_kernel, (unsigned)blocks, split::THREADS, args, smem, s);
  } else {
    const int CL = split::lane_cluster(n);
    const size_t smem = split::lane_bytes((int)(n / CL), work != nullptr);
    cudaFuncSetAttribute(lane_timeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = CL;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(W * CL));
    cfg.blockDim = dim3(split::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, lane_timeline_kernel, in, flags, out, (uint64_t*)work, (int)W, (int)n, CL, r);
  }
  return (int)cudaGetLastError();
}
