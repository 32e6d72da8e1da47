"""Small versions of the cells for tests on the CPU: the pore on the
(2, 10) generated mesh (N=209), the double layer at L_n = 1 um, a few
steps per episode. Each names where its program makes its steps."""

SMALL = {
    "pore_gmpnp.carried_schedule": {
        "program": {"mesh_resolution": [2, 10]},
        "workload": {"run": {"n_steps": 4, "record_full": False}}},
    "edl_mpnp.exact20": {"program": {"L_n": 1e-6},
                         "workload": {"run": {"n_steps": 3}}},
    "pore_gmpnp.sweep3": {"program": {"mesh_resolution": [2, 10]},
                          "workload": {"episode_steps": 2}},
    "edl_mpnp.sweep3": {"program": {"L_n": 1e-6},
                        "workload": {"episode_steps": 3}},
}

#: where each cell's program makes its step: (module, step factories)
STEP_FACTORIES = {
    "pore_gmpnp.carried_schedule": (
        "gmpnp_tpu_torch.models.pore_3d",
        ("make_carried_step", "make_recovering_carried_step",
         "make_implicit_step", "make_recovering_step")),
    "edl_mpnp.exact20": (
        "gmpnp_tpu_torch.models.edl_1d",
        ("make_carried_step", "make_recovering_carried_step",
         "make_implicit_step", "make_recovering_step")),
    "pore_gmpnp.sweep3": ("gmpnp_tpu_torch.parallel.sweep",
                          ("make_implicit_step_lanes",)),
    "edl_mpnp.sweep3": ("gmpnp_tpu_torch.parallel.sweep",
                        ("make_implicit_step_lanes",)),
}

SEED = 2 ** 31 + 977

#: cells kept as files for a later benchmark PR but not in BENCHMARK.json
#: (their host-bound runs spread too widely on the card for any bound the
#: benchmark may set; PERF.md, section 7): the tests still drive them
SHELVED = [{"name": "edl_mpnp.exact20", "config": "edl_mpnp_50um",
            "traffic": "exact20", "chips": 1, "why": "1D CR path"},
           {"name": "edl_mpnp.sweep3", "config": "edl_mpnp_50um",
            "traffic": "sweep3", "chips": 1, "why": "1D lane path"}]


def manifest():
    """BENCHMARK.json with the shelved cells added, each reporting the
    metrics of the pore sweep."""
    from benchmark import run

    m = run.load_json("BENCHMARK.json")
    have = {w["name"] for w in m["workloads"]}
    shelved = [w for w in SHELVED if w["name"] not in have]
    m["workloads"] = m["workloads"] + shelved
    for metric in m["end_to_end"] + m["per_layer"]:
        if "pore_gmpnp.sweep3" in metric.get("workloads", ()):
            metric["workloads"] = metric["workloads"] + [
                w["name"] for w in shelved]
    return m


def run_small(name, seed=SEED, trace=0):
    import torch

    from benchmark import run

    torch.set_num_threads(1)
    return run.run_cell(manifest(), name, seed, 0.01, trace, "cpu",
                        SMALL[name])
