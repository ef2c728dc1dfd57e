// Early exit inside a CUDA graph: the fused decode loop's "any slot still
// live?" test as a conditional node (CUDA >= 12.4).
//
// The JAX package's fused decode chunk (engine/fused/loop.py) is a
// `lax.while_loop` whose condition, `i < n_steps & any(act & budget > 0)`,
// is evaluated on the device: a finished batch runs no more model calls.
// PyTorch's CUDA graphs (2.11) offer no conditional node, so the port adds
// them through the runtime API. The chunk's steps are one WHILE node whose
// body is ONE decode step; `live_cond_kernel`, one block that ORs
// `act[m] && budget[m] > 0` over the slots (none while an optional `gate`
// flag is false, or once the step counter reaches `n`), sets the node's
// condition before the first iteration and again at the end of each. (An
// IF node a step, the first design, costs a dead chunk its skipped bodies:
// ~0.1 us a node of each, tools/torch_graph_probe.py.) An IF node guards
// the chunk's page gather. Bound: launch latency only (reads 5 B a slot).
//
// `k8s_cond_begin` is called while PyTorch captures `stream`: it creates
// the condition's handle in the graph being captured, captures the
// liveness kernel, adds the IF or WHILE node after everything captured so
// far (and makes it the stream's only dependency), then starts capturing
// `body_stream` into the node's body graph. The caller runs the body on
// `body_stream` and ends with `k8s_cond_end`, which for a WHILE node first
// captures the liveness kernel at the body's end.

#include <cuda_runtime.h>

namespace {

struct Cond {
  const bool* act;
  const int* budget;
  int M;
  const bool* gate;          // may be null
  const long long* counter;  // may be null: no step bound
  long long n;
};

__global__ void live_cond_kernel(cudaGraphConditionalHandle handle, Cond c) {
  __shared__ int live;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  const bool open = (c.gate == nullptr || *c.gate) && (c.counter == nullptr || *c.counter < c.n);
  for (int m = threadIdx.x; m < c.M && open; m += blockDim.x) {
    if (c.act[m] && c.budget[m] > 0) live = 1;  // every writer stores the same value
  }
  __syncthreads();
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, live ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t st, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  const cudaGraphEdgeData* edges = nullptr;
  return cudaStreamGetCaptureInfo(st, status, &id, graph, deps, &edges, n_deps);
#else
  return cudaStreamGetCaptureInfo(st, status, &id, graph, deps, n_deps);
#endif
}

Cond make_cond(const void* act, const void* budget, int M, const void* gate,
               const void* counter, long long n) {
  return Cond{static_cast<const bool*>(act), static_cast<const int*>(budget), M,
              static_cast<const bool*>(gate), static_cast<const long long*>(counter), n};
}

}  // namespace

// kind 0: IF, kind 1: WHILE. On success *handle_out holds the condition's
// handle, which k8s_cond_end needs for a WHILE node.
extern "C" int k8s_cond_begin(void* stream, void* body_stream, int kind, const void* act,
                              const void* budget, int M, const void* gate, const void* counter,
                              long long n, unsigned long long* handle_out) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(st, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  live_cond_kernel<<<1, 128, 0, st>>>(handle, make_cond(act, budget, M, gate, counter, n));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the dependencies now end at the liveness kernel
  err = capture_info(st, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int k8s_cond_end(void* body_stream, int kind, unsigned long long handle,
                            const void* act, const void* budget, int M, const void* gate,
                            const void* counter, long long n) {
  cudaStream_t st = static_cast<cudaStream_t>(body_stream);
  cudaError_t launch_err = cudaSuccess;
  if (kind == 1) {
    live_cond_kernel<<<1, 128, 0, st>>>(handle, make_cond(act, budget, M, gate, counter, n));
    launch_err = cudaGetLastError();
  }
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(st, &body);  // always: leave no capture open
  return launch_err != cudaSuccess ? launch_err : err;
}
