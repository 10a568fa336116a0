// Error reporting shared by the kernels' C entry points, and the lifetime of
// host buffers that a captured CUDA graph reads.
#include <atomic>

#include <cuda_runtime.h>

extern "C" const char* lako_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

// a user object's destructor: runs on a CUDA thread, so it only sets a flag
void CUDART_CB mark_released(void* flag) {
  static_cast<std::atomic<int>*>(flag)->store(1, std::memory_order_release);
}

}  // namespace

// A copy captured into a CUDA graph reads its host source at every replay.
// For the graph being captured on `stream`, *hold receives a flag that turns
// to 1 once that graph and every executable graph made from it are
// destroyed (a CUDA user object the graph owns); lako_graph_released reads
// it. Returns a cudaError_t code.
extern "C" int lako_graph_hold(void** hold, void* stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  auto* flag = new std::atomic<int>(0);
  cudaUserObject_t object;
  err = cudaUserObjectCreate(&object, flag, mark_released, 1, cudaUserObjectNoDestructorSync);
  if (err != cudaSuccess) {
    delete flag;
    return (int)err;
  }
  err = cudaGraphRetainUserObject(graph, object, 1, cudaGraphUserObjectMove);
  if (err != cudaSuccess) {
    cudaUserObjectRelease(object, 1);  // its destructor sets the flag, which stays allocated
    return (int)err;
  }
  *hold = flag;
  return 0;
}

// 1 once the graph of `hold` is gone (and `hold` is freed: ask no more), else 0.
extern "C" int lako_graph_released(void* hold) {
  auto* flag = static_cast<std::atomic<int>*>(hold);
  if (!flag->load(std::memory_order_acquire)) return 0;
  delete flag;
  return 1;
}
