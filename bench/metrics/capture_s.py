"""Seconds of the engine's ``warmup()``: every (model, bucket) runner
built and its CUDA graph captured, one staging slot each."""


def read(run):
    return run.capture_s
