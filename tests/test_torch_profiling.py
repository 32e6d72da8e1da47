"""The port's recorder (``gmpnp_tpu_torch.utils.profiling``): spans off and
on, nesting, step ids, self time, counters, the trace file, and the
program run with tracing on against tracing off.

- Off, a span records nothing and reads no clock; a decorated function
  tests the flag on every call, not when it was decorated.
- A small pore transient (carried chord Newton, a chord budget that forces
  the exact fallback and a refresh) and a 3-lane lane-batched pore sweep
  shaped as the benchmark's ``sweep3`` run with tracing on and off: the
  states are bitwise equal and the ``StepStats`` equal, and between them
  every span of the program appears but ``host.read``, which only a read
  from a card opens (the card test below), and ``assembly.facets``, which
  only a form with boundary fluxes opens (the rxn-diff pore below).
- The carried factor counters: ``factors.init`` + ``refresh`` +
  ``fallback`` equals the number of ``slab_prepare`` calls.
- The reaction-diffusion pore with a chord budget of one iteration: its
  wall and exit fluxes open ``assembly.facets`` spans (the faithful GMPNP
  pore none), ``chord.failed*`` count exactly the abandoned attempts'
  Newton and Krylov iterations, each re-solve runs in a
  ``step.fallback`` span, and the counts are the same traced or not.
- On a card (``-m cuda``; skipped without one): a kernel's launch record
  lies inside the span that launched it, and its end, within 50 us,
  inside the span that synchronised after it: spans and the profiler's
  records share one clock.

    python -m pytest tests/test_torch_profiling.py -q
    python -m pytest tests/test_torch_profiling.py -m cuda --noconftest
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.models import pore_3d  # noqa: E402
from gmpnp_tpu_torch.parallel import sweep  # noqa: E402
from gmpnp_tpu_torch.solve import timeloop  # noqa: E402
from gmpnp_tpu_torch.utils import profiling  # noqa: E402
from gmpnp_tpu_torch.utils.profiling import (  # noqa: E402
    count, span, trace_profile, tracing)

#: every span the program opens
SPANS = {"step", "step.update", "step.fallback", "newton.iter",
         "assembly.residual", "assembly.jacobian", "assembly.facets",
         "linear.factor", "linear.solve", "linear.krylov", "host.read",
         "sweep.build", "sweep.batch"}


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock as a counter: each read advances 10 ns."""
    t = [0]

    def now():
        t[0] += 10
        return t[0]

    monkeypatch.setattr(profiling, "_now", now)
    return t


@span("test.decorated")
def _decorated(x):
    return x + 1


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(profiling, "_now", no_clock)
    assert span("a") is span("a")
    with span("a"):
        with span("b", lanes=3):
            assert _decorated(1) == 2
    assert profiling.begin_step() == 0
    assert profiling._RECORDS == [] and profiling._STACK == []


def test_nesting_parents_and_step_ids(clock):
    with tracing() as tr:
        with span("outer"):
            prev = profiling.begin_step()
            with span("a", lanes=2):
                with span("b"):
                    pass
            with span("c"):
                pass
            profiling.end_step(prev)
            second = profiling.begin_step()
            with span("d"):
                pass
            profiling.end_step(second)
        with span("e"):
            pass
    names = [s.name for s in tr.spans]
    assert names == ["outer", "a", "b", "c", "d", "e"]
    assert [s.parent for s in tr.spans] == [-1, 0, 1, 0, 0, -1]
    steps = [s.step for s in tr.spans]
    assert steps[0] == 0 and steps[5] == 0
    assert steps[1] == steps[2] == steps[3] > 0
    assert steps[4] > steps[1]
    assert tr.spans[1].attrs == {"lanes": 2}
    assert all(s.start_ns < s.end_ns for s in tr.spans)
    assert tr.start_ns <= tr.spans[0].start_ns
    assert tr.spans[-1].end_ns <= tr.end_ns
    assert profiling._RECORDS == [] and not profiling._ON


def test_self_time_and_totals(clock):
    with tracing() as tr:
        with span("p"):             # 20 .. 70 (tracing read 10)
            with span("q"):         # 30 .. 40
                pass
            with span("q"):         # 50 .. 60
                pass
    assert [(s.start_ns, s.end_ns) for s in tr.spans] == [
        (20, 70), (30, 40), (50, 60)]
    assert tr.self_ns() == [30, 10, 10]
    tot = tr.totals()
    assert tot["p"] == {"calls": 1, "total_ns": 50, "self_ns": 30}
    assert tot["q"] == {"calls": 2, "total_ns": 20, "self_ns": 20}
    lines = tr.report().splitlines()
    assert lines[0].startswith("p") and "2 calls" in lines[1]


def test_decorator_tests_the_flag_per_call():
    assert _decorated(1) == 2
    with tracing() as tr:
        assert _decorated(2) == 3
    assert [(s.name, s.attrs) for s in tr.spans] == [
        ("test.decorated", {"kind": "_decorated"})]
    assert _decorated.__name__ == "_decorated"


def test_nested_trace_gets_its_own_spans():
    with tracing() as outer:
        with span("x"):
            with tracing() as inner:
                with span("y"):
                    pass
    assert [(s.name, s.parent) for s in inner.spans] == [("y", -1)]
    assert [(s.name, s.parent) for s in outer.spans] == [("x", -1),
                                                         ("y", 0)]


def test_counters_always_on_and_deltas():
    n0 = profiling.COUNTS.get("test.count", 0)
    count("test.count")
    with tracing() as tr:
        count("test.count", 4)
        torch.ones(3).sum()
    assert profiling.COUNTS["test.count"] == n0 + 5
    assert tr.counts["test.count"] == 4


def test_trace_profile_writes_the_spans_beside_the_ops(tmp_path):
    d = str(tmp_path / "trace")
    with trace_profile(d) as tr:
        with span("outer", lanes=2):
            torch.ones(64, 64).cumsum(0)
    assert [s.name for s in tr.spans] == ["outer"]
    with open(os.path.join(d, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "gmpnp_span"]
    assert len(mine) == 1 and mine[0]["args"] == {"lanes": 2, "step": 0}
    ops = [e for e in events if e.get("name") == "aten::cumsum"]
    assert ops
    # one clock: the op the span ran lies inside the span (us)
    t0, t1 = mine[0]["ts"], mine[0]["ts"] + mine[0]["dur"]
    assert all(t0 - 1 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1
               for e in ops)
    with trace_profile(None) as none:
        assert none is None


# -- the program, tracing on against tracing off ------------------------------

def _stats_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def test_carried_pore_same_bits_and_factor_counts():
    """Chord budget 2 fails the chord attempt at the cold step (the exact
    fallback), and ``refresh_iters=1`` refreshes after a slow chord
    step."""
    cfg = pore_3d.Pore3DConfig(
        mesh_resolution=(2, 8),
        linear=timeloop.LinearConfig(kind="slab_direct", refresh="carried",
                                     chord_dtype="f32", chord_max_iter=2,
                                     refresh_iters=1))
    prog = pore_3d.build(cfg, device="cpu")
    off = prog.run(n_steps=3)
    with tracing() as tr:
        on = prog.run(n_steps=3)
    assert torch.equal(off[1], on[1]) and torch.equal(off[3], on[3])
    assert _stats_equal(off[2], on[2])

    # the faithful GMPNP pore has no boundary flux: no facet span opens
    names = {s.name for s in tr.spans}
    assert SPANS - names == {"host.read", "sweep.build", "sweep.batch",
                             "assembly.facets"}
    c = tr.counts
    assert c.get("factors.init") == 1
    # the abandoned chord attempt at the cold step, its re-solve in a span
    # of its own (whose factors count as ``factors.fallback``)
    fallbacks = sum(1 for s in tr.spans if s.name == "step.fallback")
    assert fallbacks == c["chord.failed"] == 1
    assert c["chord.failed_iters"] == 2
    assert c.get("factors.fallback", 0) > 0 and c.get("factors.refresh", 0)
    prepares = sum(1 for s in tr.spans if s.name == "linear.factor"
                   and s.attrs["kind"] == "slab_prepare")
    assert (c["factors.init"] + c["factors.refresh"]
            + c["factors.fallback"]) == prepares
    # every span of a step carries the step's id; one id per step
    steps = [s for s in tr.spans if s.name == "step"]
    assert [s.attrs["index"] for s in steps] == [0, 1, 2]
    assert len({s.step for s in steps}) == 3
    by_step = {}
    for s in tr.spans:
        by_step.setdefault(s.step, set()).add(s.name)
    for s in steps:
        assert {"step", "step.update"} <= by_step[s.step]
    # host self time is accounted: the step spans' self time is >= 0
    own = tr.self_ns()
    assert all(own[i] >= 0 for i, s in enumerate(tr.spans))


@pytest.fixture(scope="module")
def rxn_chord_fails():
    """The reaction-diffusion pore at (2, 10), carried, with a chord
    budget of one iteration, so that the cold step's chord attempt fails:
    the step with tracing off, then with it on, every ``newton_solve``
    call and its result kept."""
    cfg = pore_3d.Pore3DConfig(
        physics="rxn_diff", L=50e-9, R=5e-9, mesh_resolution=(2, 10),
        linear=timeloop.LinearConfig(kind="slab_direct", refresh="carried",
                                     chord_dtype="f32", chord_max_iter=1))
    prog = pore_3d.build(cfg, device="cpu")
    calls = []
    solve = timeloop.newton_solve

    def spy(*a, **kw):
        res = solve(*a, **kw)
        calls.append((kw["max_iter"], res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timeloop, "newton_solve", spy)
        before = dict(profiling.COUNTS)
        off = prog.run(n_steps=1)
        counts = {k: v - before.get(k, 0)
                  for k, v in profiling.COUNTS.items()
                  if v != before.get(k, 0)}
        off_calls = list(calls)
        with tracing() as tr:
            on = prog.run(n_steps=1)
    return off, on, counts, tr, off_calls


def test_rxn_diff_facet_spans(rxn_chord_fails):
    """Each residual and Jacobian of the rxn-diff pore opens one
    ``assembly.facets`` span for the wall (S2) and one for the exit (S3),
    inside its assembly span; the entry has no flux."""
    *_, tr, _ = rxn_chord_fails
    facets = [s for s in tr.spans if s.name == "assembly.facets"]
    assert {s.attrs["marker"] for s in facets} == {pore_3d.S2, pore_3d.S3}
    parents = [tr.spans[s.parent].name for s in facets]
    assert set(parents) == {"assembly.residual", "assembly.jacobian"}
    for name in ("assembly.residual", "assembly.jacobian"):
        n = sum(1 for s in tr.spans if s.name == name)
        assert parents.count(name) == 2 * n


def test_rxn_diff_failed_chord_counted(rxn_chord_fails):
    """``chord.failed*`` add up exactly the abandoned chord attempts (the
    calls with the chord's budget that did not converge), and each is
    followed by a ``step.fallback`` span."""
    _, _, counts, tr, calls = rxn_chord_fails
    failed = [res for max_iter, res in calls
              if max_iter == 1 and not res.converged]
    assert failed
    assert counts["chord.failed"] == len(failed)
    assert counts["chord.failed_iters"] == sum(r.iterations for r in failed)
    assert counts["chord.failed_krylov"] == sum(r.linear_iters
                                                for r in failed)
    assert sum(r.linear_iters for r in failed) > 0
    fallbacks = sum(1 for s in tr.spans if s.name == "step.fallback")
    assert fallbacks == len(failed)


def test_rxn_diff_counts_same_traced(rxn_chord_fails):
    """Tracing on changes no state, no ``StepStats`` and no counter."""
    off, on, counts, tr, _ = rxn_chord_fails
    assert torch.equal(off[3], on[3]) and _stats_equal(off[2], on[2])
    for key in ("chord.failed", "chord.failed_iters", "chord.failed_krylov",
                "factors.init", "factors.fallback", "factors.refresh"):
        assert counts.get(key, 0) == tr.counts.get(key, 0), key


def test_sweep3_same_bits_and_spans():
    """Three lanes as one lane-batched transient (``chunk=3``, the carried
    factor downgraded to ``refresh='step'``), as the benchmark's
    ``sweep3``."""
    cfg = pore_3d.Pore3DConfig(
        mesh_resolution=(2, 8),
        linear=timeloop.LinearConfig(kind="slab_direct", refresh="carried",
                                     chord_dtype="f32"))
    volts = [-1.0, -0.75, -0.5]
    off = sweep.run_pore_voltage_sweep(cfg, volts, n_steps=2, chunk=3,
                                       device="cpu")
    with tracing() as tr:
        on = sweep.run_pore_voltage_sweep(cfg, volts, n_steps=2, chunk=3,
                                          device="cpu")
    assert torch.equal(off[0], on[0]) and _stats_equal(off[1], on[1])
    names = {s.name for s in tr.spans}
    assert SPANS - names == {"host.read", "step.fallback", "assembly.facets"}
    batch = [s for s in tr.spans if s.name == "sweep.batch"]
    assert len(batch) == 1 and batch[0].attrs["lanes"] == 3
    assert {s.attrs["lanes"] for s in tr.spans if s.name == "step"} == {3}
    # refresh='step': one factor per lane per step
    assert tr.counts.get("factors.step") == 3 * 2


# -- the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_spans_share_the_profilers_clock():
    """Five trials of a ~0.1 ms sleep kernel launched in one span and
    waited for in the next, after one launch that warms the profiler (its
    first launch takes 1.6-2 ms on the H100): every launch record lies
    inside its launch span, and in at least four trials the kernel's end
    lies inside the wait span, within 50 us of its end.  (The host leaves
    a 0.1 ms synchronize 4-7 us after the kernel's end, a 10 ms one 46-55
    us after; a trial can lose the host to another process.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from gmpnp_tpu_torch.sync import to_host

    trials, cycles = 5, 200_000
    x = torch.ones(4, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        with tracing() as tr:
            for _ in range(trials):
                with span("launch"):
                    torch.cuda._sleep(cycles)
                with span("wait"):
                    torch.cuda.synchronize()
            assert to_host(x.sum()) == 4.0
    assert [s.name for s in tr.spans] == ["launch", "wait"] * trials + [
        "host.read"]
    events = list(prof.profiler.kineto_results.events())
    calls = {e.correlation_id(): e for e in events
             if e.device_type().name != "CUDA" and e.name().startswith("cu")}
    # the sleep kernels (~0.1 ms each) after the warm-up one, in order
    kernels = sorted((e for e in events if e.device_type().name == "CUDA"
                      and e.duration_ns() > 50_000),
                     key=lambda e: e.start_ns())[1:]
    assert len(kernels) == trials
    ends_ok = []
    for k, launch, wait in zip(kernels, tr.spans[0::2], tr.spans[1::2]):
        call = calls.get(k.correlation_id()) or calls.get(
            k.linked_correlation_id())
        assert call is not None and "launch" in call.name().lower()
        at = (launch.start_ns, call.start_ns(), launch.end_ns)
        assert at[0] <= at[1] <= at[2], at
        end = k.start_ns() + k.duration_ns()
        ends_ok.append(wait.start_ns <= end <= wait.end_ns <= end + 50_000)
    assert sum(ends_ok) >= trials - 1, ends_ok
