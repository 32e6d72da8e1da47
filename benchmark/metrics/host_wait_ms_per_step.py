"""Host ms per lane-step in the program's ``host.read`` spans (its reads
of device tensors, ``sync.to_host``): the time the host waits for the
card, in the episode that ``harness/program_trace.py`` traces."""


def read(run):
    prog = run.get("program")
    if not prog or not prog["lane_steps"]:
        return None
    return prog["host_read_ms"] / prog["lane_steps"]
