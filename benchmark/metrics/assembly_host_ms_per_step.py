"""Host ms per lane-step in the program's assembly spans
(``assembly.residual``, ``assembly.jacobian``; one inside another counts
once), less the host reads inside them, in the episode that
``harness/program_trace.py`` traces: no synchronize ends them."""


def read(run):
    prog = run.get("program")
    if not prog or not prog["lane_steps"]:
        return None
    return prog["assembly_host_ms"] / prog["lane_steps"]
