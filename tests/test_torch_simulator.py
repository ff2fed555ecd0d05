"""The port's copies of the planner's numpy family (``core/simulator``,
``core/baselines``) against the JAX package's, on the cases of
``tests/test_simulator.py``: both run the same numpy code on the same
seeded traces, so every decode latency is equal float for float.
"""
import pytest

import repro.core.baselines as ref_baselines
import repro.core.simulator as ref_simulator
import repro_torch.core.baselines as baselines
import repro_torch.core.simulator as simulator


def _sim_case(case, sim, base):
    spec = sim.MoESpec(n_layers=8, n_experts=32, top_k=4, d_model=1024,
                       d_expert=1024)
    hw = sim.HW()
    budget = 8 * 6 * spec.expert_bytes_full

    def trace(steps=40, seed=1, batch=1):
        return sim.make_layer_trace(spec.n_layers, spec.n_experts,
                                    spec.top_k, steps, alpha=1.2, seed=seed,
                                    batch=batch)

    def warm():
        return [s[0] for s in sim.make_layer_trace(1, spec.n_experts,
                                                   spec.top_k, 400,
                                                   alpha=1.2, seed=7)]

    def run(s, t):
        return [float(x) for x in sim.run_decode(s, t)]

    if case == "baselines":
        t = trace()
        return [run(s, t) for s in (
            sim.ZipMoESim(spec, hw, budget, warm_trace=warm(), plan=True),
            base.AccelerateSim(spec, hw, budget),
            base.DeepSpeedSim(spec, hw, budget),
            base.MoEInfinitySim(spec, hw, budget))]
    if case == "planning":
        t = trace(seed=2)
        return [run(sim.ZipMoESim(spec, hw, budget, warm_trace=warm(),
                                  plan=True), t),
                run(sim.ZipMoESim(spec, hw, budget, plan=False), t)]
    if case == "eviction":
        t = trace(seed=3, steps=60)
        return [run(sim.ZipMoESim(spec, hw, budget, plan=False,
                                  eviction=ev), t)
                for ev in ("rank", "fifo", "lru", "marking")]
    if case == "memory":
        t = trace(seed=4)
        return [run(sim.ZipMoESim(spec, hw, b, warm_trace=warm(),
                                  plan=True), t)
                for b in (budget / 4, budget, budget * 4)]
    if case == "deepspeed":
        t = trace(seed=5, steps=10)
        return [run(base.DeepSpeedSim(spec, hw, b), t)
                for b in (budget, budget * 8)]
    if case == "batch":
        out = []
        for batch in (1, 8):
            t = trace(seed=6, batch=batch)
            out += [run(sim.ZipMoESim(spec, hw, budget, plan=False), t),
                    run(base.AccelerateSim(spec, hw, budget), t)]
        return out
    assert case == "consts"
    c = sim.profile_consts(spec, hw)
    return [c.u, c.v, c.c, c.L, c.K, c.n_tensors,
            sim.exec_time(spec, hw, tokens=1),
            sim.exec_time(spec, hw, tokens=2)]


@pytest.mark.parametrize("case", ["baselines", "planning", "eviction",
                                  "memory", "deepspeed", "batch", "consts"])
def test_simulator_and_baselines_parity(case):
    got = _sim_case(case, simulator, baselines)
    want = _sim_case(case, ref_simulator, ref_baselines)
    assert got == want
