"""Typed configuration of a run (the port of ``tpudml/core/config.py``:
``DistributedConfig``, ``DataConfig``, ``TrainConfig``, ``build_parser``
and ``config_from_args``).

Same fields, flags, defaults, environment names and reference aliases
as the JAX package. The ``coordinator_address`` is the rendezvous of
``torch.distributed``: ``host:port`` (a TCP store, as
``MASTER_ADDR``/``MASTER_PORT`` give it) or an init-method URL
(``tcp://host:port``, ``file:///path``). JAX's ``MeshConfig`` has no
counterpart: the process group replaces the mesh (one process a device,
its ranks the replicas), so ``TrainConfig`` has no ``mesh`` field.

``--plan plan.json`` (``python -m tpudml_torch.plan``) fills the knobs the
command line left at their defaults from the plan's ``engine_config``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

# The TrainConfig knobs a plan's engine_config fills (--plan).
PLAN_KNOBS = ("zero1", "accum_steps", "sentinel", "obs", "aggregation")


@dataclass
class DistributedConfig:
    """Process-level topology: ``process_id`` of ``num_processes``
    processes meeting at ``coordinator_address`` (None = one process and
    no process group). JAX's ``cpu_collectives`` has no counterpart: the
    device picks the backend (NCCL for CUDA, gloo for the CPU)."""

    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0
    initialize_timeout_s: int = 300
    # True when the world size was given (--n_devices or the environment),
    # so an entry point can hold it to the process group's size.
    explicit_world: bool = False

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        """Build from env vars: TPUDML_COORDINATOR / TPUDML_NUM_PROCESSES /
        TPUDML_PROCESS_ID first, then MASTER_ADDR/MASTER_PORT (+
        RANK/WORLD_SIZE), the names ``torchrun`` sets."""
        coord = os.environ.get("TPUDML_COORDINATOR")
        if coord is None:
            addr = os.environ.get("MASTER_ADDR")
            port = os.environ.get("MASTER_PORT")
            if addr and port:
                coord = f"{addr}:{port}"
        nproc = os.environ.get(
            "TPUDML_NUM_PROCESSES", os.environ.get("WORLD_SIZE")
        )
        return cls(
            coordinator_address=coord,
            num_processes=int(nproc) if nproc is not None else 1,
            process_id=int(os.environ.get("TPUDML_PROCESS_ID", os.environ.get("RANK", "0"))),
            explicit_world=nproc is not None,
        )


@dataclass
class DataConfig:
    """Dataset + division strategy: ``division`` "partition" (shared seed,
    disjoint strides) or "sampling" (per-rank seeds, with replacement
    across ranks), sections/task3.tex:19-24."""

    dataset: str = "mnist"  # mnist | cifar10 | synthetic
    data_dir: str = "./data"
    batch_size: int = 200  # per-replica batch (reference task1: 200, task2/3/4: 32)
    division: str = "partition"  # partition | sampling
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True
    synthetic_fallback: bool = True  # use deterministic synthetic data if files absent


@dataclass
class TrainConfig:
    """Top-level training configuration for the task entry points."""

    epochs: int = 1
    lr: float = 1e-3
    momentum: float = 0.0
    optimizer: str = "adam"  # gd | sgd | adam | adam_ref
    aggregation: str = "allreduce"  # allreduce | allgather  (task2 contract)
    log_every: int = 20  # reference cadence: print/log every 20 iters
    bottleneck_rank: int | None = None  # straggler-injection target rank
    bottleneck_delay_s: float = 0.1  # reference: model-mp.py:47
    measure_comm: bool = False  # split-step comm-time accounting mode
    zero1: bool = False  # ZeRO-1 weight-update sharding on the DP engine
    sentinel: bool = False  # in-graph step sentinel (skip non-finite updates)
    obs: bool = False  # flight recorder: trace.json + StepStats
    accum_steps: int = 1  # gradient-accumulation micro-batches per step
    log_dir: str = "./logs"
    profile: bool = False  # capture a profiler trace into the run dir
    ckpt_dir: str | None = None  # enable checkpointing under this directory
    ckpt_every: int = 0  # steps between rolling checkpoints (0 = end only)
    resume: bool = False  # restore the latest checkpoint before training
    seed: int = 0
    dist: DistributedConfig = field(default_factory=DistributedConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def fingerprint(self) -> str:
        """Rank-invariant program identity for the cross-process
        same-program check (``assert_same_program``): every field except
        the per-process ``dist`` block, rank-targeted fault injection, and
        host-local paths."""
        d = dataclasses.asdict(self)
        for k in ("dist", "bottleneck_rank", "log_dir", "ckpt_dir"):
            d.pop(k, None)
        d["data"].pop("data_dir", None)
        return repr(dict(sorted(d.items())))


def _add_flag(parser: argparse.ArgumentParser, name: str, default: Any,
              annotation: str = "") -> None:
    typ = type(default)
    if typ is bool:
        parser.add_argument(f"--{name}", action=argparse.BooleanOptionalAction, default=default)
    elif default is None:
        # Optional fields: the parser type from the annotation, so e.g.
        # --bottleneck_rank yields an int, not a str.
        typ = int if "int" in annotation else float if "float" in annotation else str
        parser.add_argument(f"--{name}", type=typ, default=None)
    else:
        parser.add_argument(f"--{name}", type=typ, default=default)


def build_parser(defaults: TrainConfig | None = None,
                 extra: Sequence[str] = ()) -> argparse.ArgumentParser:
    """CLI parser exposing the flat fields of TrainConfig and DataConfig plus
    the reference's historical flag names (``--n_devices``, ``--rank``,
    ``--master_addr``, ``--master_port``, ``--mode``) and ``--plan``
    (reference: codes/task2/model.py:92-102, codes/task4/model.py:142-151)."""
    defaults = defaults or TrainConfig()
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("dist", "data"):
            continue
        _add_flag(p, f.name, getattr(defaults, f.name), str(f.type))
    taken = {f.name for f in dataclasses.fields(TrainConfig)}
    for f in dataclasses.fields(DataConfig):
        if f.name not in taken:  # e.g. `seed`: one --seed flag feeds both configs
            _add_flag(p, f.name, getattr(defaults.data, f.name), str(f.type))
    p.add_argument("--n_devices", type=int, default=None, help="world size (reference parity)")
    p.add_argument("--rank", type=int, default=None, help="process id (reference parity)")
    p.add_argument("--master_addr", type=str, default=None)
    p.add_argument("--master_port", type=str, default=None)
    p.add_argument("--mode", type=str, default=None, help="alias of --division (task4 parity)")
    p.add_argument("--plan", type=str, default=None, metavar="PLAN_JSON",
                   help="apply a planner-emitted plan.json (python -m "
                        "tpudml_torch.plan): its engine_config fills every knob "
                        "left at its default (explicit flags win)")
    for name in extra:
        p.add_argument(name)
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """Materialize a TrainConfig from parsed CLI args + environment."""
    cfg = TrainConfig()
    for f in dataclasses.fields(TrainConfig):
        if f.name in ("dist", "data"):
            continue
        if hasattr(args, f.name):
            setattr(cfg, f.name, getattr(args, f.name))
    for f in dataclasses.fields(DataConfig):
        if hasattr(args, f.name):
            setattr(cfg.data, f.name, getattr(args, f.name))
    cfg.data.seed = cfg.seed  # single --seed governs data division too
    cfg.dist = DistributedConfig.from_env()
    if getattr(args, "n_devices", None) is not None:
        cfg.dist.num_processes = args.n_devices
        cfg.dist.explicit_world = True
    if getattr(args, "rank", None) is not None:
        cfg.dist.process_id = args.rank
    if getattr(args, "master_addr", None) is not None and getattr(args, "master_port", None):
        cfg.dist.coordinator_address = f"{args.master_addr}:{args.master_port}"
    if getattr(args, "mode", None):
        # task4 historical values: "division" -> partition, "sampling" -> sampling
        cfg.data.division = {"division": "partition", "sampling": "sampling"}.get(
            args.mode, args.mode)
    # Planner output (python -m tpudml_torch.plan). Same precedence contract
    # as the env knobs below: the plan's engine_config fills only the knobs
    # the user left at their defaults, so explicit flags always win.
    if getattr(args, "plan", None):
        from tpudml_torch.plan.emit import load_plan

        ec = load_plan(args.plan)["engine_config"]
        defaults = TrainConfig()
        for name in PLAN_KNOBS:
            if name in ec and getattr(cfg, name) == getattr(defaults, name):
                setattr(cfg, name, ec[name])
    # Fault-injection knobs exported by a launcher ride the environment so
    # the command line stays rank-agnostic; the CLI wins over them.
    if cfg.bottleneck_rank is None and os.environ.get("TPUDML_BOTTLENECK_RANK"):
        cfg.bottleneck_rank = int(os.environ["TPUDML_BOTTLENECK_RANK"])
        if cfg.bottleneck_delay_s == TrainConfig.bottleneck_delay_s:
            cfg.bottleneck_delay_s = float(
                os.environ.get("TPUDML_BOTTLENECK_DELAY_S", cfg.bottleneck_delay_s))
    return cfg
