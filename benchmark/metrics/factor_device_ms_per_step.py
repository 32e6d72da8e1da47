"""Device ms per lane-step of the operations launched inside the
program's ``linear.factor`` spans (factorizations and preconditioner
builds), in the episode that ``harness/program_trace.py`` traces: each
operation is owned by the innermost span open when its CUDA call
launched it."""

from benchmark.harness.program_trace import FACTOR


def read(run):
    prog = run.get("program")
    if not prog or not prog["lane_steps"]:
        return None
    by = prog["device_by_span"]
    return sum(by.get(n, 0.0) for n in FACTOR) * 1e3 / prog["lane_steps"]
