// The whole lean run as one CUDA graph: a conditional WHILE node whose
// body's last launch sets the condition itself.
//
// No TPU kernel: this is the counterpart of the `cond` of the JAX
// package's `lax.while_loop`, which runs on the device after every cycle
// (armon_tpu/core/step.py:461-478) or every K5 launch (:438-456), so the
// compiled loop is dispatched once and read once a run.
//
// The outer graph holds one WHILE node (CUDA 12.3+). Its condition is
// created with the value 1 and set back to it at every launch
// (`cudaGraphCondAssignDefault`), so the body runs at least once: the
// host checks that the run starts before it launches the graph. The graph
// is made in two steps, because the body's last launch takes the node's
// handle as an argument: `armon_while_create` makes the graph, the node
// and its handle; the host then records the body, a torch capture of the
// loop body's launches over whole steps (core/graphs.py) in which the
// last step's finishing launch carries the handle and the iteration
// count; `armon_while_attach` copies that capture into the WHILE body as a
// child graph and instantiates. CUDA lets a kernel inside a child-graph
// node of the body set the condition (an H100 with nvcc 12.9 and driver
// 580: chip_smoke.py phase 0, `while_alone`), so the capture need not be
// made straight into the body graph (`cudaStreamBeginCaptureToGraph`).
// The last launch's thread that writes the predicate the host would read
// after the same steps (iscal[run] after a cycle, in K1, K2 or K4's
// `cfl_tail`; iscal[next] after a K5 launch) adds 1 to the count and sets
// the condition from it (`set_while`, common.cuh). Every other launch carries handle 0 and sets nothing. A
// cycle launched past the run's end leaves every field and scalar as it
// was, so the body's length does not change the result; the count tells
// the host how many bodies ran, for the launch counts.
//
// Bound on this card: latency. Setting the condition adds 8 bytes of
// count traffic and one branch to one thread of the body's last launch;
// what is left a WHILE iteration is the node's turn-around, which
// chip_smoke.py phase 14 (c) times with `countdown_kernel` as the body.
// A separate condition kernel would add a dependent node to every
// iteration's critical path.
//
// Every entry point returns the CUDA error code (0 on success).

#include <cuda_runtime.h>

#include "common.cuh"

namespace armon {

// The WHILE node's measurement body: takes one from the predicate `pred`
// and, with `cond`, counts the iteration and sets the condition from what
// is left, as the solver's last launch does with its own predicate.
__global__ void countdown_kernel(int* pred, cudaGraphConditionalHandle cond, int* count) {
  const int left = *pred - 1;
  *pred = left;
  set_while(cond, count, left != 0);
}

}  // namespace armon

// Makes the outer graph with its WHILE node: *graph_out (the caller's,
// `armon_while_destroy`), the node's condition handle *cond_out, which the
// body's last launch takes, and the node's body graph *body_out (the outer
// graph's own).
extern "C" int armon_while_create(void** graph_out, unsigned long long* cond_out,
                                  void** body_out) {
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle = 0;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 1, cudaGraphCondAssignDefault);
  cudaGraphNodeParams loop = {};
  cudaGraphNode_t node = nullptr;
  if (e == cudaSuccess) {
    loop.type = cudaGraphNodeTypeConditional;
    loop.conditional.handle = handle;
    loop.conditional.type = cudaGraphCondTypeWhile;
    loop.conditional.size = 1;
    e = cudaGraphAddNode(&node, graph, nullptr, 0, &loop);
  }
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return e;
  }
  *graph_out = graph;
  *cond_out = handle;
  *body_out = loop.conditional.phGraph_out[0];
  return cudaSuccess;
}

// Copies the recorded body `child` into the WHILE body `body` of `graph`
// and instantiates: *exec_out is the caller's. The caller keeps and
// destroys its own `child`, and `graph` on failure too.
extern "C" int armon_while_attach(void* graph, void* body, void* child, void** exec_out) {
  cudaGraphNode_t node = nullptr;
  cudaError_t e = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(body), nullptr,
                                             0, static_cast<cudaGraph_t>(child));
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, static_cast<cudaGraph_t>(graph), 0);
  if (e != cudaSuccess) return e;
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

extern "C" int armon_countdown(int* pred, unsigned long long cond, int* count, void* stream) {
  armon::countdown_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(pred, cond, count);
  return cudaGetLastError();
}
