"""SLO-aware admission: price a decode step before occupying a slot. The
port of ``tpudml/serve/sched.py`` (host Python, the same numbers).

A decode step streams the weights once plus each active slot's KV window
from device memory and, under tensor parallelism, moves two activation
allreduces per block (priced with ``comm.timing.collective_wire_bytes``).
The scheduler admits the queue head only while

    predicted_step_seconds(active + 1) <= slo.tpot_budget_s

and defers it otherwise (event ``("defer", rid, -1, step)``): FIFO order
survives because admission only peeks the head. An idle engine always
admits, so an unsatisfiable budget degrades to one tenant at a time
instead of deadlocking the queue.

The model prices the work a step does; the engine's step runs ALL slots,
so a measured step time is nearly flat in occupancy. The defaults
(``hbm_gbps=100``) are the JAX package's round stand-ins; pass the card's
rates for real capacity planning.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpudml_torch.comm.timing import collective_wire_bytes

_CACHE_ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1, "bf16_sim": 4, "int8_sim": 4}

# Stored bytes per parameter element, keyed by ServeConfig.weight_quant
# (the "_sim" oracle keeps f32 storage, so it prices like f32).
_PARAM_ITEMSIZE = {None: 4, "f32": 4, "bf16": 2, "int8": 1, "int8_sim": 4}


@dataclass(frozen=True)
class SLOConfig:
    """Latency contract + machine constants for admission pricing:
    ``tpot_budget_s`` the per-token cadence promised every admitted
    tenant; ``hbm_gbps`` / ``ici_gbps`` the memory and interconnect rates."""

    tpot_budget_s: float
    hbm_gbps: float = 100.0
    ici_gbps: float = 45.0

    def __post_init__(self):
        if self.tpot_budget_s <= 0:
            raise ValueError("tpot_budget_s must be > 0")
        if self.hbm_gbps <= 0 or self.ici_gbps <= 0:
            raise ValueError("hbm_gbps/ici_gbps must be > 0")


class DecodeCostModel:
    """Static per-step cost of the serving engine's decode step.

    bytes(step) = params_read + n_active × (per_slot_window + logits_tail)
                  + spec_draft
    seconds(step) = bytes/hbm + ring_wire_bytes/ici

    The dense engine streams ``max_len`` rows per slot; the paged engine
    gathers the slot's ``max_pages × page_size`` positions. Spec decode adds
    K draft passes (draft weights re-read per drafted token); admission
    prices the pessimistic one-token floor."""

    def __init__(self, model, cfg, slo: SLOConfig, *, world: int = 1,
                 draft_model=None):
        self.slo = slo
        self.world = world
        kv_heads = model.num_kv_heads or model.num_heads
        head_dim = model.embed_dim // model.num_heads
        itemsize = _CACHE_ITEMSIZE[cfg.cache_kind]
        if cfg.cache_layout == "paged":
            window_rows = cfg.max_pages * cfg.page_size
        else:
            window_rows = cfg.max_len
        # K + V rows across all layers, once per step per active slot.
        self.per_slot_bytes = (
            2 * window_rows * kv_heads * head_dim * itemsize * model.num_layers
        )
        p_item = _PARAM_ITEMSIZE[getattr(cfg, "weight_quant", None)]
        self.params_bytes = self._params_bytes(model, itemsize=p_item) // max(world, 1)
        self.draft_bytes = 0
        self.spec_k = cfg.spec_k or 0
        if draft_model is not None and self.spec_k:
            self.draft_bytes = (
                self._params_bytes(draft_model, itemsize=p_item) // max(world, 1)
            )
        # Decode tail: the unfused step writes each slot's [vocab] logits
        # row and reads it back; the fused head keeps it on chip.
        if getattr(cfg, "fused_head", False):
            self.tail_bytes_per_slot = 0
        else:
            self.tail_bytes_per_slot = 2 * model.vocab_size * 4
        # Two activation allreduces per block per step under TP.
        act_bytes = model.embed_dim * 4
        self.wire_bytes_per_slot = (
            2 * model.num_layers * collective_wire_bytes("psum", act_bytes, world)
        )

    @staticmethod
    def _params_bytes(model, *, itemsize: int = 4) -> int:
        """Stored parameter bytes at ``itemsize`` bytes an element."""
        d, v, n_layers = model.embed_dim, model.vocab_size, model.num_layers
        kv = model.num_kv_heads or model.num_heads
        head_dim = d // model.num_heads
        mlp = getattr(model, "mlp_ratio", 4) * d
        per_block = d * d * 2 + d * kv * head_dim * 2 + 2 * d * mlp
        return itemsize * (v * d * 2 + n_layers * per_block)  # embed+head+blocks

    def step_seconds(self, n_active: int) -> float:
        hbm = (
            self.params_bytes
            + self.spec_k * self.draft_bytes
            + n_active * (self.per_slot_bytes + self.tail_bytes_per_slot)
        )
        wire = n_active * self.wire_bytes_per_slot
        return hbm / (self.slo.hbm_gbps * 1e9) + wire / (self.slo.ici_gbps * 1e9)

    def admit_ok(self, n_active: int) -> bool:
        """May the scheduler add one more tenant? Always from idle."""
        if n_active == 0:
            return True
        return self.step_seconds(n_active + 1) <= self.slo.tpot_budget_s
