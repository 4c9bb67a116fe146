"""The planner's verification step (``tpudml_torch.plan.emit.
verify_candidate``) in gloo jobs of 2 and 4 CPU ranks, against the JAX
planner's traced verification on the simulated CPU mesh.

- the dp and zero1 candidates' ``predicted.comm_wire_bytes`` is JAX's
  stamped value: the gradient's collectives exactly, the metrics' scalar
  sums within 64 bytes;
- fsdp and tp: the port counts the weight gathers and gradient
  reduce-scatters its engines issue — the engine's own count
  (``GSPMDParallel.step_wire_bytes``) plus the loss's scalar sum; JAX's
  are 0, because XLA's partitioner inserts those collectives after the
  jaxpr the planner traces is made (a defined difference, not a parity
  target);
- a verified plan: the winner has no finding and nothing was demoted;
- a winner whose gradient all-reduce is removed on purpose (a test
  double) is demoted with ``replicas_differ`` and the next survivor wins;
- the planner prunes what the constructors reject: every survivor builds,
  and every capability-pruned candidate whose knob reaches the engine
  ``build_candidate`` builds is refused with the table's message (the
  others' guards live in their owner: task5 for ``pp_fused_xent``,
  ``tp_overlap_matmul`` for ``tp_overlap_needs_model_axis``, the DP engine
  for ``zero1_overlap`` — JAX's ``build_candidate`` passes them to no
  constructor either).
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

from tests.torch_dist_worker import spawn  # noqa: E402

WORLDS = (2, 4)
# Keys whose guard is in the constructor build_candidate calls, by engine.
CONSTRUCTOR_KEYS = {
    "dp": {"zero1_overlap_needs_zero1", "zero1_overlap_needs_accum"},
    "zero1": {"zero1_overlap_needs_accum"},
    "fsdp": {"gspmd_fused_xent_accum"},
    "tp": {"gspmd_fused_xent_accum"},
    "fsdp_tp": {"gspmd_fused_xent_accum"},
    "pp_dp": set(),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two gloo jobs (run side by side) and JAX's verification of the
    same base candidates, traced on the simulated CPU mesh meanwhile:
    ``(jobs by world, JAX's predicted.comm_wire_bytes by (world, engine))``."""
    from tpudml.plan.emit import verify_candidate
    from tpudml.plan.space import Candidate, flagship_lm

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(spawn, "plan", tmp_path_factory.mktemp(f"plan{w}"), world=w)
                   for w in WORLDS}
        stamps = {}
        for w in WORLDS:
            for engine in ("dp", "zero1", "fsdp", "tp"):
                cand = Candidate(engine=engine,
                                 mesh=((("model" if engine == "tp" else "data"), w),),
                                 zero1=engine == "zero1", zero1_overlap=False, accum_steps=1,
                                 fused_xent=False, sentinel=False, obs=False)
                stamps[w, engine] = verify_candidate(flagship_lm(), cand)["predicted"][
                    "comm_wire_bytes"]
        return {w: f.result() for w, f in futures.items()}, stamps


@pytest.fixture(scope="module")
def jobs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_stamps(runs):
    return runs[1]


def _grad_wire(world: int) -> float:
    """The ring model's bytes of the flagship's f32 gradient all-reduce
    (the same for ZeRO-1's reduce-scatter + all-gather)."""
    from tpudml_torch.comm.timing import collective_wire_bytes
    from tpudml_torch.plan import flagship_lm

    return collective_wire_bytes("psum", flagship_lm().param_count() * 4, world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ["dp", "zero1"])
def test_dp_and_zero1_wire_bytes_are_jax_stamps(jobs, jax_stamps, world, engine):
    want = jax_stamps[world, engine]
    grad = _grad_wire(world)
    assert want == grad + {2: 8, 4: 12}[world]  # 532,488 / 798,732: the gradient + scalars
    for r in jobs[world]:
        v = r["verify"][engine]
        assert v["ok"] and v["findings"] == []
        got = v["predicted"]["comm_wire_bytes"]
        assert 0 <= got - grad <= 64  # the gradient's bytes exactly, then the scalar sums
        assert abs(got - want) <= 64


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ["fsdp", "tp"])
def test_fsdp_and_tp_count_their_engines_collectives(jobs, jax_stamps, world, engine):
    assert jax_stamps[world, engine] == 0.0  # XLA's partitioner adds them after the trace
    for r in jobs[world]:
        v = r["verify"][engine]
        assert v["ok"] and v["findings"] == []
        extra = v["predicted"]["comm_wire_bytes"] - r["engine_bytes"][engine]
        assert r["engine_bytes"][engine] > 0 and 0 <= extra <= 64


def test_a_pipeline_of_two_blocks_a_stage_verifies(jobs):
    """pp_dp on {data: 2, stage: 2} with four layers (two decoder blocks a
    stage): the step runs, the replicas agree, and its wire bytes include
    the stage boundary's point-to-point sends."""
    for r in jobs[4]:
        v = r["verify"]["pp_dp"]
        assert v["ok"] and v["findings"] == []
        assert v["predicted"]["comm_wire_bytes"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_verified_plan_has_no_finding(jobs, world):
    plans = [r["plan"] for r in jobs[world]]
    assert all(p == plans[0] for p in plans)  # every rank plans the same
    ver = plans[0]["verification"]
    assert ver["ok"] and ver["findings"] == [] and ver["demoted"] == []
    assert ver["entrypoint"] == f"plan:{plans[0]['winner']['candidate']['key']}"
    assert plans[0]["predicted"]["comm_wire_bytes"] > 0
    log = jobs[world][0]["log"]
    assert [e["key"] for e in log] == [plans[0]["winner"]["candidate"]["key"]]


@pytest.mark.parametrize("world", WORLDS)
def test_a_lost_allreduce_is_demoted_and_the_next_survivor_wins(jobs, world):
    plan = jobs[world][0]["broken"]
    demoted = plan["verification"]["demoted"]
    assert len(demoted) == 1
    first = plan["ranking"][0]["candidate"]["key"]
    assert demoted[0]["candidate"]["key"] == first
    assert {f["rule"] for f in demoted[0]["findings"]} == {"replicas_differ"}
    assert plan["winner"]["candidate"]["key"] == plan["ranking"][1]["candidate"]["key"]
    assert plan["verification"]["ok"]


@pytest.mark.parametrize("world", WORLDS)
def test_planner_prunes_exactly_what_the_constructor_rejects(jobs, world):
    r = jobs[world][0]
    assert r["built"] > 0
    refused = 0
    for key, rule, got, message in r["pruned"]:
        engine = key.split("[")[0]
        if rule in CONSTRUCTOR_KEYS[engine]:
            assert got == message, key
            refused += 1
        else:
            assert got is None, key
    assert refused > 0
