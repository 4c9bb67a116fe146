"""Cluster topology specification (the docker-compose.yml replacement;
the port of ``tpudml/launch/cluster.py``)."""

from __future__ import annotations

import dataclasses
import json
import os
import socket
from dataclasses import dataclass, field


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ClusterSpec:
    """Everything the launcher needs to stand up an N-process job.

    The reference encodes this per-node in compose YAML — image, mount,
    rank flags, rendezvous DNS name (codes/task2/docker-compose.yml:4-45).
    Here it is one typed, JSON-serializable object; the rendezvous
    (``coordinator_address``) is exported as ``TPUDML_COORDINATOR``, which
    ``tpudml_torch.core.DistributedConfig.from_env`` reads as the process
    group's TCP store.

    ``platform``: None (the default) leaves the ranks the card, one card a
    rank as ``distributed_init`` picks it (NCCL); ``"cpu"`` hides the card
    (``CUDA_VISIBLE_DEVICES=""``) and exports ``TPUDML_DEVICE=cpu``, the
    task CLIs' ``--device`` default, so the ranks run on the CPU over gloo.
    JAX's default is the simulated CPU cluster (ROADMAP.md queue 3).
    ``devices_per_process`` is JAX's virtual-device count; the port drives
    one device a process, so it must be 1.
    """

    num_processes: int = 2
    coordinator_host: str = "127.0.0.1"
    coordinator_port: int = 0  # 0 → pick a free port at launch
    # None = the card (NCCL); "cpu" = the ranks on the host over gloo (the
    # mp.spawn analogue), the card hidden.
    platform: str | None = None
    devices_per_process: int = 1  # one device a process in the port
    timeout_s: float | None = None  # whole-job wall-clock limit
    grace_s: float = 5.0  # SIGTERM → SIGKILL escalation delay
    # Elastic recovery: relaunch the whole job after a failure/timeout up
    # to this many times. Pair the command with --ckpt_dir/--resume so
    # each restart continues from the last checkpoint (SURVEY.md §5.3/5.4:
    # checkpoint/restart IS the recovery story).
    max_restarts: int = 0
    # Seeded exponential backoff between restart attempts: attempt k waits
    # restart_backoff_s * restart_backoff_factor**(k-1), plus a uniform
    # jitter of up to restart_backoff_jitter × that delay drawn from
    # random.Random(restart_backoff_seed) — deterministic per spec, but
    # decorrelated across jobs so a mass preemption doesn't produce a
    # thundering-herd reconnect. 0 (the default) restarts immediately,
    # preserving the pre-backoff behaviour.
    restart_backoff_s: float = 0.0
    restart_backoff_factor: float = 2.0
    restart_backoff_jitter: float = 0.0
    restart_backoff_seed: int = 0
    # Straggler/fault injection (task2 bottleneck-node experiment).
    bottleneck_rank: int | None = None
    bottleneck_delay_s: float = 0.1
    env: dict[str, str] = field(default_factory=dict)  # extra env, all ranks
    rank_env: dict[int, dict[str, str]] = field(default_factory=dict)

    def coordinator_address(self) -> str:
        if self.coordinator_port == 0:
            # Resolved once per launch; persisted so every rank agrees.
            self.coordinator_port = _free_port()
        return f"{self.coordinator_host}:{self.coordinator_port}"

    def environ_for_rank(self, rank: int) -> dict[str, str]:
        """Child-process environment for ``rank`` (layered over os.environ):
        the TPUDML_* rendezvous contract read by DistributedConfig.from_env,
        the platform's device knobs, and fault-injection exports."""
        env = dict(os.environ)
        env.update(self.env)
        env.update(self.rank_env.get(rank, {}))
        env.update(
            TPUDML_COORDINATOR=self.coordinator_address(),
            TPUDML_NUM_PROCESSES=str(self.num_processes),
            TPUDML_PROCESS_ID=str(rank),
        )
        if self.devices_per_process != 1:
            raise ValueError(f"devices_per_process={self.devices_per_process}: the port "
                             "drives one device a process")
        if self.platform == "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
            env["TPUDML_DEVICE"] = "cpu"
        elif self.platform not in (None, "cuda"):
            raise ValueError(f"platform {self.platform!r}: use None (the card) or 'cpu'")
        if self.bottleneck_rank is not None:
            env["TPUDML_BOTTLENECK_RANK"] = str(self.bottleneck_rank)
            env["TPUDML_BOTTLENECK_DELAY_S"] = str(self.bottleneck_delay_s)
        return env

    # ------------------------------------------------------------- serde

    def to_json(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str | os.PathLike) -> "ClusterSpec":
        with open(path) as f:
            raw = json.load(f)
        raw["rank_env"] = {int(k): v for k, v in raw.get("rank_env", {}).items()}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown ClusterSpec fields: {sorted(unknown)}")
        return cls(**raw)
