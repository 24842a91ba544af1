"""Tracing frontend: compile user-defined PyTorch models into the layer IR.

Port of ``src/repro/frontend/__init__.py``.  The paper's second pillar is
a compiler that takes a *user-defined model* as input (§V-A); this package
is that ingestion path for plain torch callables and ``nn.Module``s in eval
mode, the second frontend next to the declarative ``GraphBuilder``:

    from repro_torch import frontend, gcv
    from repro_torch.frontend import nn

    def model(x):                      # a user-defined model
        h = torch.relu(x @ w1 + b1)
        h = nn.message_passing(adjacency, h, reduce="max")
        return h @ w2 + b2

    graph = frontend.to_graph(model, {"x": example}, name="mymodel")
    compiled = gcv.compile(model, {"x": example})    # the one-call façade

Stages: ``trace.trace_model`` records the model's aten graph with
``make_fx`` (fake tensors) and interprets it into proto layers,
``canonicalize.canonicalize`` rewrites the idioms (bias adds, softmax
chains, DM reshuffles, the KNN distance expression) back into the paper's
layer vocabulary, and the resulting ``Graph`` flows through the six-pass
compiler unchanged.
"""
from repro_torch.core.ir import Graph
from repro_torch.frontend import nn                            # noqa: F401
from repro_torch.frontend.canonicalize import canonicalize     # noqa: F401
from repro_torch.frontend.lint import lint                     # noqa: F401
from repro_torch.frontend.trace import (TraceGraph,            # noqa: F401
                                        TraceNode, UnsupportedOpError,
                                        trace_model)


def to_graph(fn, example_inputs, *, name: str = "traced") -> Graph:
    """Trace + canonicalize a torch callable (or an ``nn.Module`` in eval
    mode) into a layer ``Graph``."""
    return canonicalize(trace_model(fn, example_inputs, name=name))
