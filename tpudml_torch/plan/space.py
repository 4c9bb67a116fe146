"""Planner search space: model specs and candidate enumeration (the port
of ``tpudml/plan/space.py``, the same candidates in the same order with
the same keys, so that ``plan.json`` is the JAX package's byte for byte).

Pure Python — enumeration must stay cheap and deterministic so the
planner can be exercised without a process group and its output
byte-pinned.  A *candidate* is one fully-specified engine
configuration; the flat dict form (:meth:`Candidate.to_dict`) is the
record the capability-table predicates and the prune pass read.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Sequence

#: Engine chains the planner knows how to build, score, and emit.
ENGINES = ("dp", "zero1", "fsdp", "tp", "fsdp_tp", "pp_dp")


@dataclass(frozen=True)
class ModelSpec:
    """Decoder-only LM shape the planner sizes candidates against.

    ``per_chip_batch`` is the data-parallel per-chip row count; the
    global workload per step is fixed at ``per_chip_batch × world``
    rows regardless of mesh shape, so candidates that do not shard the
    batch (pure TP) are charged the full global batch per device —
    comparisons are per fixed global work, never per whatever batch
    happens to fit.
    """

    vocab_size: int
    embed_dim: int
    num_heads: int
    num_layers: int
    seq_len: int
    per_chip_batch: int
    dtype_bytes: int = 4
    mlp_ratio: int = 4

    def global_batch(self, world: int) -> int:
        return self.per_chip_batch * world

    def param_count(self) -> int:
        """Parameter count of the matching TransformerLM (rope=True, so
        no learned position table): embedding + per-block attention/MLP/
        layernorms + final norm + untied head."""
        d, v, h = self.embed_dim, self.vocab_size, self.mlp_ratio * self.embed_dim
        attn = 4 * (d * d + d)
        mlp = d * h + h + h * d + d
        norms = 2 * 2 * d
        block = attn + mlp + norms
        return v * d + self.num_layers * block + 2 * d + d * v + v

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelSpec":
        return cls(**d)


def flagship_lm() -> ModelSpec:
    """The small flagship spec the JAX package plans and tests at (its
    ``bench.py`` dryrun rows' shape)."""
    return ModelSpec(
        vocab_size=256,
        embed_dim=64,
        num_heads=4,
        num_layers=2,
        seq_len=128,
        per_chip_batch=4,
    )


@dataclass(frozen=True)
class Candidate:
    """One point of the search space. ``mesh`` is an axis-name → size
    mapping stored as a sorted tuple of pairs (frozen dataclasses need
    hashable fields)."""

    engine: str
    mesh: tuple  # tuple[tuple[str, int], ...]
    zero1: bool
    zero1_overlap: bool
    accum_steps: int
    fused_xent: bool
    sentinel: bool
    obs: bool
    # Chunked psum-overlapped TP matmuls (parallel/overlap.py): hide
    # (K−1)/K of the per-block activation allreduce behind the chunked
    # matmul. Only meaningful with a model axis — the capability row
    # ``tp_overlap_needs_model_axis`` prunes the rest of the lattice.
    tp_overlap: bool = False

    @property
    def mesh_dict(self) -> dict:
        return dict(self.mesh)

    def key(self) -> str:
        """Canonical id — stable sort key and the plan.json label."""
        mesh = ",".join(f"{a}={s}" for a, s in self.mesh)
        flags = (
            f"z{int(self.zero1)}{int(self.zero1_overlap)}"
            f"a{self.accum_steps}f{int(self.fused_xent)}"
            f"s{int(self.sentinel)}o{int(self.obs)}"
            f"t{int(self.tp_overlap)}"
        )
        return f"{self.engine}[{mesh}]{flags}"

    def to_dict(self) -> dict:
        """Flat record for the capability predicates and plan.json."""
        return {
            "engine": self.engine,
            "mesh": self.mesh_dict,
            "zero1": self.zero1,
            "zero1_overlap": self.zero1_overlap,
            "accum_steps": self.accum_steps,
            "fused_xent": self.fused_xent,
            "sentinel": self.sentinel,
            "obs": self.obs,
            "tp_overlap": self.tp_overlap,
            "aggregation": "allreduce",
            "schedule": "gpipe" if self.engine == "pp_dp" else None,
            "key": self.key(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        return cls(
            engine=d["engine"],
            mesh=tuple(sorted(d["mesh"].items())),
            zero1=d["zero1"],
            zero1_overlap=d["zero1_overlap"],
            accum_steps=d["accum_steps"],
            fused_xent=d["fused_xent"],
            sentinel=d["sentinel"],
            obs=d["obs"],
            tp_overlap=d.get("tp_overlap", False),  # pre-v3 plan records
        )


def _two_axis(world: int) -> list:
    """(a, b) with a*b == world, both >= 2 — every genuine 2-D mesh."""
    return [
        (a, world // a) for a in range(2, world) if world % a == 0
        and world // a >= 2
    ]


def _engine_meshes(engine: str, world: int) -> list:
    """Mesh shapes an engine chain can occupy at ``world`` chips.

    At ``world == 1`` only plain DP is enumerable: every other chain
    exists to shard something across chips (ZeRO-1/FSDP shard state
    over data, TP shards features, PP shards layers) and degenerates
    to DP-with-extra-collectives on a single chip — the planner's
    answer there is an *empty* mesh list, which the re-plan path turns
    into an honest "infeasible at world 1" receipt rather than a
    silently-degenerate candidate.
    """
    if engine == "dp":
        return [(("data", world),)]
    if engine in ("zero1", "fsdp"):
        return [(("data", world),)] if world >= 2 else []
    if engine == "tp":
        return [(("model", world),)] if world >= 2 else []
    if engine == "fsdp_tp":
        return [
            (("data", a), ("model", b)) for a, b in _two_axis(world)
        ]
    if engine == "pp_dp":
        return [
            (("data", a), ("stage", b)) for a, b in _two_axis(world)
        ]
    raise ValueError(f"unknown engine {engine!r}")


def enumerate_candidates(
    world: int, engines: Sequence[str] | None = None
) -> list:
    """The full knob cross-product, in deterministic order.

    Deliberately includes combinations the capability table rejects
    (e.g. ``zero1_overlap`` without zero1, pp×fused_xent): the prune
    pass drops them *with the table's reason*, so the plan's dropped-
    candidate report demonstrates the shared rejection rules firing
    rather than silently never generating the combination.
    """
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    out = []
    for engine in engines if engines is not None else ENGINES:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        for mesh in _engine_meshes(engine, world):
            for overlap in (False, True):
                for accum in (1, 2):
                    for fused in (False, True):
                        for sentinel in (False, True):
                            for obs in (False, True):
                                for tp_ov in (False, True):
                                    out.append(Candidate(
                                        engine=engine,
                                        mesh=mesh,
                                        zero1=engine == "zero1",
                                        zero1_overlap=overlap,
                                        accum_steps=accum,
                                        fused_xent=fused,
                                        sentinel=sentinel,
                                        obs=obs,
                                        tp_overlap=tp_ov,
                                    ))
    out.sort(key=Candidate.key)
    return out
