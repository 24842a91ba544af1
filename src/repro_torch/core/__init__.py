"""GCV-Turbo core on PyTorch: layer IR, six-pass compiler, plan runtime.

Port of ``src/repro/core/__init__.py``:

  ir.py          layer-graph IR + builder frontend
  passes/        Step 1 fusion, Step 2 uniform lowering, Step 3 tiling,
                 Step 4 sparsity-aware primitive mapping (+ 4b kernel
                 binding), Step 5 scheduling, Step 6 liveness
  compiler.py    pass driver -> ExecutionPlan
  runtime/       op-registry handlers (@register_op)
  executor.py    per-sample plan execution with liveness freeing
  weights.py     load externally supplied parameters into a plan
  perf_model.py  FPGA cycle model (paper §IV/§VI)
"""
from repro_torch.core.compiler import CompileOptions, compile_graph  # noqa
from repro_torch.core.executor import build_runner                   # noqa
from repro_torch.core.ir import Graph, GraphBuilder, Layer           # noqa
from repro_torch.core.plan import ExecutionPlan, MatOp               # noqa
