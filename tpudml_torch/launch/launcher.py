"""Process launcher with rank-tagged output and failure containment (the
port of ``tpudml/launch/launcher.py``)."""

from __future__ import annotations

import dataclasses
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

from tpudml_torch.launch.cluster import ClusterSpec

POLL_S = 0.2


@dataclass
class LaunchResult:
    returncodes: list[int]
    elapsed_s: float
    timed_out: bool = False
    failed_rank: int | None = None
    attempts: int = 1
    # Backoff delay actually slept before each restart (empty when the
    # job succeeded first try or restart_backoff_s == 0).
    backoffs_s: list[float] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.returncodes)


def restart_backoff(spec: ClusterSpec, rng: random.Random, attempt: int) -> float:
    """Seeded exponential backoff delay before restart ``attempt`` (1-based):
    ``restart_backoff_s * factor**(attempt-1)`` plus uniform jitter drawn
    from ``rng`` — the one backoff schedule shared by :func:`launch`'s
    whole-job restarts and the elastic controller's re-forms
    (``tpudml_torch.elastic``), deterministic per (spec, seed) and equal
    to JAX's schedule."""
    if spec.restart_backoff_s <= 0:
        return 0.0
    delay = spec.restart_backoff_s * spec.restart_backoff_factor ** (attempt - 1)
    if spec.restart_backoff_jitter > 0:
        delay += rng.uniform(0, spec.restart_backoff_jitter * delay)
    return delay


def _substitute(cmd: list[str], rank: int, world: int) -> list[str]:
    """Per-rank command templating: ``{rank}``/``{world}`` placeholders —
    the analogue of compose's per-service ``--rank={0,1}`` lines
    (codes/task2/docker-compose.yml:9-17,30-38)."""
    return [a.replace("{rank}", str(rank)).replace("{world}", str(world)) for a in cmd]


def _pump(proc: subprocess.Popen, rank: int, sink) -> threading.Thread:
    """Forward a child's merged output line-by-line with a rank tag (the
    compose service-name prefix analogue; reference relies on `python -u`
    prints per rank, sections/task2.tex:157)."""

    def run():
        for line in proc.stdout:  # type: ignore[union-attr]
            sink.write(f"[rank {rank}] {line}")
            sink.flush()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def launch(
    cmd: list[str],
    spec: ClusterSpec | None = None,
    *,
    sink=None,
) -> LaunchResult:
    """Spawn ``spec.num_processes`` copies of ``cmd`` and supervise them.

    Containment semantics (the reference's gap, SURVEY.md §5.3: with
    synchronous collectives one dead rank leaves every other rank blocked
    forever): the first rank to exit non-zero triggers SIGTERM (then
    SIGKILL after ``grace_s``) of the whole job; ``timeout_s`` bounds total
    wall clock the same way. With ``spec.max_restarts`` > 0 a failed or
    timed-out job is relaunched whole (fresh rendezvous port) up to that
    many times — combine with the tasks' ``--ckpt_dir ... --resume`` flags
    so restarts continue from the last checkpoint. ``attempts`` on the
    result counts the runs. ``spec.restart_backoff_s`` > 0 inserts a
    seeded exponential (+ jitter) delay before each relaunch — recorded
    per attempt in ``result.backoffs_s`` and charged against
    ``timeout_s`` like any other elapsed time.
    """
    spec = spec or ClusterSpec()
    out = sink or sys.stdout
    # Each attempt runs on a COPY of the spec: an auto-picked rendezvous
    # port (coordinator_port=0) is re-picked per attempt, an explicitly
    # configured port is kept; the caller's spec is never mutated.
    auto_port = spec.coordinator_port == 0
    budget = spec.timeout_s  # whole-job wall clock, spent across attempts

    def attempt_spec(remaining: float | None) -> ClusterSpec:
        return dataclasses.replace(
            spec,
            coordinator_port=0 if auto_port else spec.coordinator_port,
            timeout_s=remaining,
        )

    # Seeded restart backoff: deterministic per (spec, seed) so restart
    # cadence is reproducible in tests, decorrelated across jobs by seed.
    rng = random.Random(spec.restart_backoff_seed)

    result = _launch_once(cmd, attempt_spec(budget), sink)
    total_elapsed = result.elapsed_s
    backoffs: list[float] = []
    attempt = 1
    while not result.success and attempt <= spec.max_restarts:
        delay = restart_backoff(spec, rng, attempt)
        remaining = None if budget is None else budget - total_elapsed - delay
        if remaining is not None and remaining <= 0:
            break  # whole-job budget exhausted — don't relaunch
        why = "timeout" if result.timed_out else f"rank {result.failed_rank} failed"
        tail = f" after {delay:.2f}s backoff" if delay > 0 else ""
        out.write(
            f"[launch] {why}; restart {attempt}/{spec.max_restarts}{tail}\n"
        )
        out.flush()
        from tpudml_torch.obs.tracer import get_tracer

        # The ambient flight recorder: restarts land on the supervisor's
        # trace as instants (nothing when none is installed).
        get_tracer().instant(
            "launch_restart", cat="launch",
            args={"attempt": attempt, "why": why, "backoff_s": delay},
        )
        if delay > 0:
            time.sleep(delay)
            total_elapsed += delay
        backoffs.append(delay)
        result = _launch_once(cmd, attempt_spec(remaining), sink)
        total_elapsed += result.elapsed_s
        attempt += 1
    result.attempts = attempt
    result.elapsed_s = total_elapsed
    result.backoffs_s = backoffs
    return result


def launch_once(
    cmd: list[str],
    spec: ClusterSpec,
    sink=None,
) -> LaunchResult:
    """Single-attempt launch: the containment core without the restart
    loop, the primitive multi-gang supervisors (``tpudml_torch.elastic``,
    ``tpudml_torch.mpmd``) build rounds from."""
    return _launch_once(cmd, spec, sink)


def _launch_once(
    cmd: list[str],
    spec: ClusterSpec,
    sink=None,
) -> LaunchResult:
    sink = sink or sys.stdout
    world = spec.num_processes
    spec.coordinator_address()  # resolve the port once, before any spawn
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []
    t0 = time.monotonic()
    timed_out = False
    failed_rank: int | None = None
    try:
        for rank in range(world):
            p = subprocess.Popen(
                _substitute(cmd, rank, world),
                env=spec.environ_for_rank(rank),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            procs.append(p)
            pumps.append(_pump(p, rank, sink))

        while True:
            codes = [p.poll() for p in procs]
            for rank, rc in enumerate(codes):
                if rc is not None and rc != 0 and failed_rank is None:
                    failed_rank = rank
            done = all(rc is not None for rc in codes)
            over_time = (
                spec.timeout_s is not None
                and time.monotonic() - t0 > spec.timeout_s
            )
            if done:
                break
            if failed_rank is not None or over_time:
                timed_out = over_time and failed_rank is None
                _terminate_all(procs, spec.grace_s)
                break
            time.sleep(POLL_S)
    except BaseException:
        # A mid-spawn failure (fork error, Ctrl-C) must not leak earlier
        # ranks as live orphans blocked in the rendezvous.
        _terminate_all(procs, spec.grace_s)
        raise
    for p in procs:
        p.wait()
    for t in pumps:
        t.join(timeout=2)
    return LaunchResult(
        returncodes=[p.returncode for p in procs],
        elapsed_s=time.monotonic() - t0,
        timed_out=timed_out,
        failed_rank=failed_rank,
    )


def _terminate_all(procs: list[subprocess.Popen], grace_s: float) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline and any(p.poll() is None for p in procs):
        time.sleep(POLL_S)
    for p in procs:
        if p.poll() is None:
            p.kill()
