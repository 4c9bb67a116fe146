"""Serving fleet: multi-replica routing, disaggregated prefill/decode, and
int8 weight quantization under elastic supervision (the port of
``tpudml.serve.fleet``).

The scale-out layer over ``tpudml_torch.serve``'s single engine: a
:class:`FleetRouter` fronts N replicas behind one FIFO line with
per-replica SLO pricing, treats replica death as a membership event
(drain → re-admit with partial tokens kept → supervised re-form with the
replan path consulted), hands KV pages between prefill- and
decode-specialist replicas through the CRC-verified checkpoint format
(``fleet.disagg``), and quantizes decode weights to int8 with the cache's
``_sim`` oracle discipline (``fleet.quant``).

Two execution forms: the deterministic in-process router (fixture
replay: ``python -m tpudml_torch.serve.fleet --fixture``) and the spawned
drill under :class:`ElasticController` (``python -m
tpudml_torch.serve.fleet --drill``).
"""

from tpudml_torch.serve.fleet.disagg import adopt_handoff, write_handoff
from tpudml_torch.serve.fleet.quant import (
    dequantize_params,
    quantize_params,
    quantized_param_bytes,
    sim_quantize_params,
)
from tpudml_torch.serve.fleet.router import (
    FLEET_FIXTURE_VERSION,
    FleetConfig,
    FleetReport,
    FleetRequestStats,
    FleetRouter,
    replay_fleet_fixture,
)


def __getattr__(name):
    # Lazy: the drill imports the controller/launcher stack, which the
    # router-only (and child) paths never need.
    if name == "run_fleet_drill":
        from tpudml_torch.serve.fleet.drill import run_fleet_drill

        return run_fleet_drill
    raise AttributeError(name)


__all__ = [
    "FLEET_FIXTURE_VERSION",
    "FleetConfig",
    "FleetReport",
    "FleetRequestStats",
    "FleetRouter",
    "adopt_handoff",
    "dequantize_params",
    "quantize_params",
    "quantized_param_bytes",
    "replay_fleet_fixture",
    "run_fleet_drill",
    "sim_quantize_params",
    "write_handoff",
]
