// The whole lean run as one CUDA graph: a conditional WHILE node and its
// condition kernel `while_cond`.
//
// No TPU kernel: this is the counterpart of the `cond` of the JAX
// package's `lax.while_loop`, which runs on the device after every cycle
// (armon_tpu/core/step.py:461-478) or every K5 launch (:438-456), so the
// compiled loop is dispatched once and read once a run.
//
// The outer graph holds one WHILE node (CUDA 12.3+). Its condition is
// created with the value 1 and set back to it at every launch
// (`cudaGraphCondAssignDefault`), so the body runs at least once: the
// host checks that the run starts before it launches the graph. The body
// is a child graph, the capture of the loop body's launches over whole
// steps (core/graphs.py), then `while_cond`: one thread that adds 1 to the
// iteration count and sets the condition from the predicate slot the host
// would read after the same steps (iscal[run] after a cycle, iscal[next]
// after a K5 launch; common.cuh `cfl_scalars`). A cycle launched past the
// run's end leaves every field and scalar as it was, so the body's length
// does not change the result; the count tells the host how many bodies
// ran, for the launch counts.
//
// Bound on this card: latency. `while_cond` reads 8 bytes and writes 4;
// what it costs is a node on the body's critical path and the node's
// turn-around between iterations, which phase 0 and phase 14 of
// chip_smoke.py time.
//
// Every entry point returns the CUDA error code (0 on success).

#include <cuda_runtime.h>

namespace armon {

__global__ void while_cond_kernel(cudaGraphConditionalHandle handle, const int* pred,
                                  int* count) {
  *count += 1;
  cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
}

}  // namespace armon

// Builds and instantiates the graph: WHILE (body: `child`, then
// while_cond(pred, count)). `child` is copied into the body, so the caller
// keeps and destroys its own. On success the caller owns *graph_out and
// *exec_out (`armon_while_destroy`).
extern "C" int armon_while_build(void* child, const int* pred, int* count, void** graph_out,
                                 void** exec_out) {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle = 0;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 1, cudaGraphCondAssignDefault);
  cudaGraphNodeParams loop = {};
  cudaGraphNode_t node = nullptr, body_node = nullptr, cond_node = nullptr;
  if (e == cudaSuccess) {
    loop.type = cudaGraphNodeTypeConditional;
    loop.conditional.handle = handle;
    loop.conditional.type = cudaGraphCondTypeWhile;
    loop.conditional.size = 1;
    e = cudaGraphAddNode(&node, graph, nullptr, 0, &loop);
  }
  cudaGraph_t body = e == cudaSuccess ? loop.conditional.phGraph_out[0] : nullptr;
  if (e == cudaSuccess)
    e = cudaGraphAddChildGraphNode(&body_node, body, nullptr, 0,
                                   static_cast<cudaGraph_t>(child));
  if (e == cudaSuccess) {
    void* args[] = {&handle, &pred, &count};
    cudaKernelNodeParams k = {};
    k.func = reinterpret_cast<void*>(armon::while_cond_kernel);
    k.gridDim = dim3(1);
    k.blockDim = dim3(1);
    k.kernelParams = args;
    e = cudaGraphAddKernelNode(&cond_node, body, &body_node, 1, &k);
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return e;
  }
  *graph_out = graph;
  *exec_out = exec;
  return cudaSuccess;
}

extern "C" int armon_while_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

extern "C" int armon_while_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t f = graph ? cudaGraphDestroy(static_cast<cudaGraph_t>(graph)) : cudaSuccess;
  return e != cudaSuccess ? e : f;
}
