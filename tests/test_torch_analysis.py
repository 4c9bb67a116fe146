"""``tpudml_torch.analysis``'s graph pass and source lint, rule by rule
(``tests/test_analysis.py``'s scenarios, re-targeted to eager PyTorch).

- every graph rule fires on its seeded step and stays silent on the
  correct twin: J100, J101, J103, J104, J105, J106, J107 (also through a
  gather of the other dim), J108 (and its ZeRO-1 and sharded-update
  twins), J109 (the E-scaled pattern fires; the port's own ragged FFN, both
  arms, is silent: a defined difference), J110, J111, J117 and J119;
- the marker strings are JAX's constants, and the regions cost nothing
  while no capture runs; the capture counts kernel launches by name,
  equal to the launch counters, and restores what it wraps;
- the AST rules fire on the port's seeded source and stay silent on its
  clean twin; P304 gives exactly JAX's findings on JAX's fixtures;
- the allowlist's matching and stale-entry detection.
"""

from __future__ import annotations

import os
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from tpudml_torch import markers  # noqa: E402
from tpudml_torch.analysis import (  # noqa: E402
    analyze_callable,
    analyze_entrypoint,
    analyze_file,
    analyze_source,
    capture,
    load_allowlist,
    split_allowed,
)
from tpudml_torch.analysis.allowlist import AllowEntry, unused_entries  # noqa: E402
from tpudml_torch.analysis.findings import Finding  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis_fixtures"
ALLOWLIST = str(REPO / "tpudml_torch" / "analysis" / "allowlist.toml")


def _rules(findings):
    return {f.rule for f in findings}


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group (the job's, if the process has one)."""
    from tpudml_torch.core import process_group

    with process_group(device="cpu") as g:
        yield g


def _tiny_lm(**kw):
    from tpudml_torch.models import TransformerLM

    base = dict(vocab_size=32, embed_dim=16, num_heads=2, num_layers=2, max_len=16, rope=True)
    base.update(kw)
    return TransformerLM(**base, device="cpu", generator=torch.Generator().manual_seed(0))


# ------------------------------------------------------------- graph pass


def test_j100_step_failure_becomes_finding():
    def broken(x):
        return x + torch.ones(x.shape[0] + 1)  # shapes do not broadcast

    bad = analyze_callable(broken, (torch.ones(4),), "fix-j100")
    assert _rules(bad) == {"J100"}
    assert bad[0].file.endswith("test_torch_analysis.py") and bad[0].line > 0
    assert "J100" not in _rules(analyze_callable(lambda x: x + 1.0, (torch.ones(4),), "ok"))


def test_j101_unmapped_group_fires_and_a_mesh_axis_is_silent(group):
    def reduce(x):
        dist.all_reduce(x)
        return x

    bad = analyze_callable(reduce, (torch.ones(4),), "fix-j101")
    assert _rules(bad) == {"J101"}
    assert bad[0].file.endswith("test_torch_analysis.py") and bad[0].line > 0
    good = analyze_callable(reduce, (torch.ones(4),), "ok-j101", axes={"data": None})
    assert "J101" not in _rules(good)

    def foreign(x):
        dist.all_reduce(x, group=dist.GroupMember.NON_GROUP_MEMBER)
        return x

    assert "J101" in _rules(analyze_callable(foreign, (torch.ones(4),), "fix-j101-foreign",
                                             axes={"data": None}))


def test_j103_host_read_in_step():
    def chatty(x):
        y = x * 2.0
        print(f"loss={float(y.sum()):.3f}", end="\r")
        return y

    bad = analyze_callable(chatty, (torch.ones(4),), "fix-j103")
    assert _rules(bad) == {"J103"}
    for read in (lambda x: x.tolist(), lambda x: x.cpu(), lambda x: x[x > 0],
                 lambda x: torch.nonzero(x)):
        assert _rules(analyze_callable(read, (torch.ones(4),), "fix-j103b")) == {"J103"}
    assert "J103" not in _rules(analyze_callable(lambda x: x * 2.0, (torch.ones(4),), "ok"))
    # a host scalar the step builds itself is no read of the device
    assert "J103" not in _rules(analyze_callable(
        lambda x: x * float(torch.tensor(0.9) ** 2), (torch.ones(4),), "ok-host"))


def test_j104_upcast_outside_accumulation():
    x16 = torch.ones(8, dtype=torch.bfloat16)
    bad = analyze_callable(lambda x: x.float() * 2.0, (x16,), "fix-j104")
    assert _rules(bad) == {"J104"}
    assert "mul" in bad[0].message
    # an upcast feeding a reduction is the intended accumulate-in-f32 idiom
    good = analyze_callable(lambda x: x.float().sum(), (x16,), "ok-j104")
    assert "J104" not in _rules(good)


def test_j105_large_closure_constant():
    big = torch.ones(600, 600)  # 1.4 MiB
    bad = analyze_callable(lambda x: x + big[0, 0], (torch.ones(2),), "fix-j105")
    assert _rules(bad) == {"J105"}
    assert "1.4 MiB" in bad[0].message
    small = torch.ones(8, 8)
    assert "J105" not in _rules(analyze_callable(lambda x: x + small[0, 0],
                                                 (torch.ones(2),), "ok-j105"))
    # the same tensor passed as an argument is the step's state, not a constant
    assert "J105" not in _rules(analyze_callable(lambda x, b: x + b[0, 0],
                                                 (torch.ones(2), big), "ok-arg"))


def test_j106_replaced_state():
    state = torch.ones(1024, 512)  # 2 MiB
    v = torch.ones(4)

    def replaces(s, v):
        return s + v.sum(), v * 2.0

    def in_place(s, v):
        return s.add_(v.sum()), v * 2.0

    bad = analyze_callable(replaces, (state, v), "fix-j106", expects_donation=True)
    assert _rules(bad) == {"J106"}
    assert bad[0].file.endswith("test_torch_analysis.py") and bad[0].line > 0
    good = analyze_callable(in_place, (state.clone(), v), "ok-j106", expects_donation=True)
    assert "J106" not in _rules(good)


def test_j106_in_place_params_do_not_hide_replaced_moments():
    """A step that updates its parameter in place but builds its 1 MiB
    moments anew each step double-buffers the moments: J106 fires (also
    when the moments share the parameter's shape and dtype); the same step
    with the moments written in place is silent."""
    rng = torch.Generator().manual_seed(0)
    p, g = torch.randn(512, 512, generator=rng), torch.randn(512, 512, generator=rng)

    def replaced_moments(p, m, v, g):
        m = 0.9 * m + 0.1 * g
        v = 0.99 * v + 0.01 * g * g
        p.sub_(0.01 * m / (v.sqrt() + 1e-8))
        return p, m, v

    def in_place_moments(p, m, v, g):
        m.mul_(0.9).add_(g, alpha=0.1)
        v.mul_(0.99).addcmul_(g, g, value=0.01)
        p.sub_(0.01 * m / (v.sqrt() + 1e-8))
        return p, m, v

    def state():
        return p.clone(), torch.zeros(512, 512), torch.zeros(512, 512), g

    bad = [f for f in analyze_callable(replaced_moments, state(), "fix-j106-moments",
                                       expects_donation=True) if f.rule == "J106"]
    assert len(bad) == 1 and "2 state input(s)" in bad[0].message, bad
    assert bad[0].file.endswith("test_torch_analysis.py") and bad[0].line > 0
    assert "J106" not in _rules(analyze_callable(in_place_moments, state(), "ok-j106-moments",
                                                 expects_donation=True))
    # moments of another shape than the parameter's (a factored second moment)
    half = lambda p, m, v, g: (p.sub_(0.01 * g), m * 0.9, v)  # noqa: E731
    mixed = analyze_callable(half, (p.clone(), torch.zeros(1024, 512), torch.zeros(8), g),
                             "fix-j106-other-shape", expects_donation=True)
    assert _rules(mixed) == {"J106"}


def test_j107_vocab_sharded_unsharded_head(group):
    """J107 fires when the UNSHARDED fused head consumes the local block of a
    vocab-sharded kernel (also after a gather of its other dim), and stays
    silent for the shard-merge wrapper and for a replicated kernel."""
    from tpudml_torch.ops import linear_cross_entropy, sharded_linear_cross_entropy

    x, w = torch.zeros(8, 4), torch.zeros(4, 32)
    lab = torch.zeros(8, dtype=torch.long)
    vocab_sharded = ((), (None, "data"), ())

    def hazard(x, w, ln):
        return linear_cross_entropy(x, w, ln)

    def fixed(x, w, ln):
        return sharded_linear_cross_entropy(x, w, ln, group=None)

    assert "J107" in _rules(analyze_callable(hazard, (x, w, lab), "fix-j107",
                                             in_specs=vocab_sharded))
    assert "J107" not in _rules(analyze_callable(fixed, (x, w, lab), "ok",
                                                 in_specs=vocab_sharded, axes={"data": None}))
    assert "J107" not in _rules(analyze_callable(hazard, (x, w, lab), "ok-replicated"))

    # 2-D: W sharded (data, model); the dim-0 gather over "data" must not
    # launder the vocab dim's sharding over "model".
    def hazard2d(x, w, ln):
        full = torch.empty(w.shape[0] * dist.get_world_size(), w.shape[1])
        dist.all_gather_into_tensor(full, w)
        return linear_cross_entropy(x, full, ln)

    bad = analyze_callable(hazard2d, (x, w, lab), "fix-j107-2d",
                           in_specs=((), ("data", "model"), ()),
                           axes={"data": None, "model": None})
    (f,) = [f for f in bad if f.rule == "J107"]
    assert "model" in f.message and "sharded_linear_cross_entropy" in f.message


class _Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.p1 = torch.nn.Parameter(torch.ones(8, 4))
        self.p2 = torch.nn.Parameter(torch.ones(16))


def test_j108_replicated_update_under_data_axis(group):
    """J108 fires on the replicated-DP shape (the gradients all-reduced over
    a data axis, then every parameter updated in full, no reduce-scatter)
    and stays silent for ZeRO-1's shape (reduce-scatter) and for an update
    of this rank's shard only."""
    axes = {"data": None}

    def replicated(m, x):
        s = x.sum()
        flat = torch.cat([(m.p1 * s).reshape(-1), (m.p2 * s).reshape(-1)]).detach()
        dist.all_reduce(flat)
        g1, g2 = flat.split([32, 16])
        with torch.no_grad():
            m.p1.sub_(0.1 * g1.view(8, 4))
            m.p2.sub_(0.1 * g2)
        return m

    found = analyze_callable(replicated, (_Two(), torch.ones(4, 4)), "fix-j108", axes=axes)
    (f,) = [f for f in found if f.rule == "J108"]
    assert "reduce-scatter" in f.message and f.line > 0

    def zero1(m, x):
        s = x.sum()
        flat = torch.cat([(m.p1 * s).reshape(-1), (m.p2 * s).reshape(-1)]).detach()
        mine = torch.empty(flat.numel() // dist.get_world_size())
        dist.reduce_scatter_tensor(mine, flat)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, mine)
        g1, g2 = full.split([32, 16])
        with torch.no_grad():
            m.p1.sub_(0.1 * g1.view(8, 4))
            m.p2.sub_(0.1 * g2)
        return m

    assert "J108" not in _rules(analyze_callable(zero1, (_Two(), torch.ones(4, 4)), "ok-z1",
                                                 axes=axes))

    def shard_update(m, x):
        s = x.sum()
        flat = torch.cat([(m.p1 * s).reshape(-1), (m.p2 * s).reshape(-1)]).detach()
        dist.all_reduce(flat)
        g1, g2 = flat.split([32, 16])
        with torch.no_grad():  # this rank's rows only, as an FSDP block
            m.p1[:4].sub_(0.1 * g1.view(8, 4)[:4])
            m.p2[:8].sub_(0.1 * g2[:8])
        return m

    assert "J108" not in _rules(analyze_callable(shard_update, (_Two(), torch.ones(4, 4)),
                                                 "ok-sharded", axes=axes))


def _stock_ragged_dw(x, g, sizes):
    """lax.ragged_dot's stock dW, written out: both operands broadcast to
    [E, P, ·] under each group's row mask, then one batched product."""
    e, p = sizes.shape[0], x.shape[0]
    ends = torch.cumsum(sizes, 0)
    rows = torch.arange(p)
    mask = (rows[None, :] >= (ends - sizes)[:, None]) & (rows[None, :] < ends[:, None])
    xm = torch.where(mask[:, :, None], x[None].expand(e, p, x.shape[1]), 0.0)
    gm = torch.where(mask[:, :, None], g[None].expand(e, p, g.shape[1]), 0.0)
    return torch.bmm(xm.transpose(1, 2), gm)


@pytest.mark.parametrize("ragged_dw", ["stock", "grouped"])
def test_j109_fires_on_the_e_scaled_dw_and_the_port_s_ragged_ffn_is_silent(ragged_dw):
    """The E-scaled pattern fires J109; the port's ragged FFN builds no such
    broadcast in either arm (the stock arm is per-slab matmuls, cost ∝
    tokens), so the rule stays silent on both: a defined difference from
    JAX, whose stock arm is lax.ragged_dot's E-scaled transpose."""
    from tpudml_torch.nn.moe import MoELayer

    sizes = torch.tensor([10, 0, 12, 10])
    bad = analyze_callable(_stock_ragged_dw, (torch.ones(32, 16), torch.ones(32, 8), sizes),
                           "fix-j109")
    (f,) = [f for f in bad if f.rule == "J109"]
    assert "4×" in f.message and f.line > 0

    moe = MoELayer(16, 4, mlp_ratio=2, dispatch="ragged", ragged_dw=ragged_dw,
                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(32, 16, generator=torch.Generator().manual_seed(1))

    def loss(x):
        y, aux = moe(x)
        (y.square().sum() + aux).backward()
        return moe.w1.grad if hasattr(moe, "w1") else None

    found = analyze_callable(loss, (x,), f"j109-{ragged_dw}", modules=(moe,))
    assert "J100" not in _rules(found), found
    assert [f for f in found if f.rule == "J109"] == []


def test_j110_cacheless_decode_fires_and_cached_is_silent():
    from tpudml_torch.serve import ServeConfig, ServingEngine, make_cacheless_decode_step

    lm = _tiny_lm()
    bad = analyze_callable(make_cacheless_decode_step(lm),
                           (torch.zeros(2, 12, dtype=torch.long),), "j110-cacheless")
    fired = [f for f in bad if f.rule == "J110"]
    assert len(fired) == 1, bad  # one finding a marked step, not a layer
    assert "full-sequence" in fired[0].message and fired[0].hint and fired[0].line > 0

    eng = ServingEngine(lm, ServeConfig(slots=2, max_len=16, prefill_chunk=4), device="cpu")
    good = analyze_callable(eng._decode, (eng.caches, torch.zeros(2, dtype=torch.long),
                                          torch.zeros(2, dtype=torch.long)), "j110-cached")
    assert [f for f in good if f.rule == "J110"] == [], good


def test_j117_full_pool_softmax_fires_and_real_paged_steps_are_silent():
    from tpudml_torch.serve import PAGED_DECODE_MARKER, ServeConfig, ServingEngine

    pool = torch.randn(5, 2, 1, 4, generator=torch.Generator().manual_seed(0))

    @markers.marked(PAGED_DECODE_MARKER)
    def pool_wide(pool, q):
        scores = q @ pool.reshape(10, 4).T  # keyed on every page of the pool
        return torch.softmax(scores, dim=-1)

    bad = analyze_callable(pool_wide, (pool, torch.ones(2, 4)), "fix-j117")
    assert _rules(bad) == {"J117"}

    eng = ServingEngine(_tiny_lm(), ServeConfig(slots=2, max_len=16, prefill_chunk=4,
                                                cache_layout="paged", page_size=4,
                                                num_pages=9, spec_k=2), device="cpu")
    table = torch.zeros((2, eng.cfg.max_pages), dtype=torch.int32)
    toks = pos = torch.zeros(2, dtype=torch.long)
    spec = analyze_callable(eng._spec, (eng.caches, eng._dcaches, table, toks, pos),
                            "j117-paged-spec")
    assert [f for f in spec if f.rule in ("J110", "J117")] == [], spec
    plain = ServingEngine(_tiny_lm(), ServeConfig(slots=2, max_len=16, prefill_chunk=4,
                                                  cache_layout="paged", page_size=4,
                                                  num_pages=9), device="cpu")
    found = analyze_callable(plain._decode, (plain.caches, table, toks, pos), "j117-paged")
    assert [f for f in found if f.rule in ("J110", "J117")] == [], found
    # the paged step's tail is the same unfused argmax: J119 covers it too
    assert len([f for f in found if f.rule == "J119"]) == 1, found


def test_j119_unfused_tail_fires_and_fused_is_silent():
    from tpudml_torch.serve import ServeConfig, ServingEngine

    def args(eng):
        return (eng.caches, torch.zeros(2, dtype=torch.long), torch.zeros(2, dtype=torch.long))

    lm = _tiny_lm()
    plain = ServingEngine(lm, ServeConfig(slots=2, max_len=16, prefill_chunk=4), device="cpu")
    fired = [f for f in analyze_callable(plain._decode, args(plain), "j119-unfused")
             if f.rule == "J119"]
    assert len(fired) == 1
    assert "full-vocab" in fired[0].message and fired[0].line > 0 and fired[0].hint
    assert fired[0].file == "tpudml_torch/serve/engine.py"
    fused = ServingEngine(lm, ServeConfig(slots=2, max_len=16, prefill_chunk=4,
                                          fused_head=True), device="cpu")
    good = analyze_callable(fused._decode, args(fused), "j119-fused")
    assert [f for f in good if f.rule in ("J110", "J119")] == [], good


def test_j119_overlap_claim_verified_against_marker(group):
    from tpudml_torch.parallel.overlap import TP_OVERLAP_MARKER

    x, w = torch.ones(8, 16), torch.ones(16, 8)

    def claiming(key):
        return {"winner": {"candidate": {"tp_overlap": True, "key": key}}}

    @markers.marked(TP_OVERLAP_MARKER)
    def overlapped(x, w):  # the marker's region, as tp_overlap_matmul opens it
        y = x @ w
        dist.all_reduce(y)
        return y

    def plain(x, w):
        y = x @ w
        dist.all_reduce(y)
        return y

    axes = {"model": None}
    ok = analyze_callable(overlapped, (x, w), "ok", plan=claiming("t1"), axes=axes)
    assert [f for f in ok if f.rule == "J119"] == [], ok
    bad = analyze_callable(plain, (x, w), "bad", plan=claiming("t1"), axes=axes)
    fired = [f for f in bad if f.rule == "J119"]
    assert len(fired) == 1 and "tp_overlap" in fired[0].message and fired[0].line > 0
    unclaiming = {"winner": {"candidate": {"tp_overlap": False, "key": "t0"}}}
    silent = analyze_callable(plain, (x, w), "none", plan=unclaiming, axes=axes)
    assert [f for f in silent if f.rule == "J119"] == []


def test_j111_unguarded_update_fires_and_sentinel_is_silent():
    """J111 fires on a plain training step, anchored at the port's
    optimizer file so that ONE allowlist entry covers every plain engine,
    and goes silent once the step carries the grad sentinel (its
    finiteness check's region). JAX's twin of this test fails under the
    installed jax (its anchors are lost); the port's anchors are real."""
    plain = analyze_entrypoint("task2_dp", device="cpu")
    fired = [f for f in plain if f.rule == "J111"]
    assert len(fired) == 1, plain
    assert fired[0].severity == "info"
    assert fired[0].file == "tpudml_torch/optim/optimizers.py" and fired[0].line > 0
    assert "is_finite" in fired[0].message
    guarded = analyze_entrypoint("dp_sentinel", device="cpu")
    assert [f for f in guarded if f.rule == "J111"] == [], guarded
    entries = load_allowlist(ALLOWLIST)
    active, _ = split_allowed(guarded, entries)
    assert active == [], active
    # the committed allowlist's one optimizers.py entry absorbs the plain finding
    active, allowed = split_allowed(plain, entries)
    assert [f for f in active if f.rule == "J111"] == []
    assert any(f.rule == "J111" for f in allowed)


# ------------------------------------------------------------- capture


@pytest.mark.parametrize("module,name,value", [
    ("tpudml.serve.engine", "SERVE_DECODE_MARKER", "tpudml_torch.serve.engine"),
    ("tpudml.serve.paged", "PAGED_DECODE_MARKER", "tpudml_torch.serve.paged"),
    ("tpudml.serve.spec", "SPEC_DECODE_MARKER", "tpudml_torch.serve.spec"),
    ("tpudml.ops.xent_kernel", "FUSED_XENT_MARKER", "tpudml_torch.ops.xent_kernel"),
    ("tpudml.ops.xent_kernel", "SHARDED_XENT_MARKER", "tpudml_torch.ops.xent_kernel"),
    ("tpudml.ops.decode_head", "FUSED_HEAD_MARKER", "tpudml_torch.ops.decode_head"),
    ("tpudml.ops.decode_head", "FUSED_HEAD_INT8_MARKER", "tpudml_torch.ops.decode_head"),
    ("tpudml.ops.junction_kernel", "ATTN_JUNCTION_MARKER", "tpudml_torch.ops.junction_kernel"),
    ("tpudml.parallel.overlap", "TP_OVERLAP_MARKER", "tpudml_torch.parallel.overlap"),
])
def test_marker_strings_equal_jax_s(module, name, value):
    import importlib

    pytest.importorskip("jax")
    assert getattr(importlib.import_module(value), name) == getattr(
        importlib.import_module(module), name)


def test_regions_cost_nothing_without_a_capture_and_the_capture_restores_what_it_wraps():
    from tpudml_torch.ops import fused_add_layernorm

    assert markers._capture is None
    bump = markers.marked("x")(lambda t: t + 1)
    assert bump(torch.ones(2)).tolist() == [2.0, 2.0] and markers._capture is None
    real = (dist.all_reduce, torch.Tensor.tolist, torch.Tensor.to,
            torch.nn.functional.one_hot)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    scale, bias = torch.ones(8), torch.zeros(8)
    cap = capture(lambda x: fused_add_layernorm(x, x, scale, bias), (x,), name="ln")
    assert cap.error is None and markers._capture is None
    assert (dist.all_reduce, torch.Tensor.tolist, torch.Tensor.to,
            torch.nn.functional.one_hot) == real
    names = [r.name for r in cap.regions]
    assert "kernel:add_layernorm_forward" in names
    # the plain version's ops are inside the opaque region
    assert any(e.opaque is not None for e in cap.events)


class _StubLibrary:
    source = Path(__file__)

    def call(self, fn, *args):
        pass


def test_capture_records_each_launch_by_name_as_the_counters_count():
    from tpudml_torch.ops.cuda_lib import Kernel

    k1 = Kernel("stub_a", _StubLibrary(), "a", replaces="x:1")
    k2 = Kernel("stub_b", _StubLibrary(), "b", replaces="x:2")

    def step():
        k1.launch(stream=0)
        k2.launch(stream=0)
        k1.launch(stream=0)

    k1.launch(stream=0)  # outside the capture: counted, not recorded
    before = {k.name: k.launches for k in (k1, k2)}
    cap = capture(step, (), name="launches")
    assert dict(cap.launches) == {k.name: k.launches - before[k.name] for k in (k1, k2)}
    assert dict(cap.launches) == {"stub_a": 2, "stub_b": 1}
    launch_events = [e for e in cap.events if e.kind == "launch"]
    assert [e.name for e in launch_events] == ["stub_a", "stub_b", "stub_a"]
    assert all(e.file.endswith("test_torch_analysis.py") for e in launch_events)


def test_backward_ops_of_an_opaque_region_stay_inside_it(group):
    """On the CPU the vocab-sharded head runs its plain version under
    autograd: the backward's ops belong to the head's region, as its
    kernels' launches do on the card, so no rule reads them (its bf16→f32
    upcasts fire no J104)."""
    from tpudml_torch.ops import SHARDED_XENT_MARKER, sharded_linear_cross_entropy

    lab = torch.zeros(8, dtype=torch.long)

    def step(x, w):
        sharded_linear_cross_entropy(x, w, lab, group=None).backward()
        return x.grad

    def inputs():
        g = torch.Generator().manual_seed(0)
        return (torch.randn(8, 4, generator=g).bfloat16().requires_grad_(),
                torch.randn(4, 32, generator=g).bfloat16().requires_grad_())

    cap = capture(step, inputs(), name="head", axes={"data": None})
    (head,) = [r for r in cap.regions if r.name == SHARDED_XENT_MARKER]
    after = [e for e in cap.events[head.last:] if e.kind == "op"]
    assert any(e.opaque == head.id for e in after), "the backward's ops left the region"
    assert [f for f in analyze_callable(step, inputs(), "head", axes={"data": None})
            if f.rule == "J104"] == []


# --------------------------------------------------------------- AST pass


SEEDED = textwrap.dedent('''
    import time

    import torch


    def a201_branch_on_tensor(x):
        y = torch.mean(x)
        if y > 0:  # A201: the test reads the device
            x = x + 1.0
        for v in torch.arange(4):  # A201: a read an element
            x = x + v
        return x


    def a202_reseeded(shape):
        g = torch.Generator().manual_seed(0)
        a = torch.randn(shape, generator=g)
        g.manual_seed(0)  # A202: the next draw repeats a
        b = torch.rand(shape, generator=g)
        return a + b


    def a203_epoch_loop(loader, model):
        seen = 0
        for epoch in range(3):  # A203: no loader.set_epoch(epoch)
            for batch in loader:
                seen += 1
        return seen


    def a204_unbracketed_timing(step, ts, batch):
        t0 = time.perf_counter()
        ts, metrics = step(ts, *batch)
        elapsed = time.perf_counter() - t0  # A204: the kernels may still run
        return ts, torch.tensor(batch[0].shape[0] / elapsed)
''')

CLEAN = textwrap.dedent('''
    import time

    import torch


    def branch_on_host_value(x):
        y = torch.mean(x).item()
        if y > 0:
            x = x + 1.0
        return x


    def independent_draws(shape):
        g = torch.Generator().manual_seed(0)
        a = torch.randn(shape, generator=g)
        b = torch.rand(shape, generator=g)
        return a + b


    def epoch_loop(loader):
        for epoch in range(3):
            loader.set_epoch(epoch)
            for batch in loader:
                pass


    def timed(step, ts, batch):
        t0 = time.perf_counter()
        ts, metrics = step(ts, *batch)
        torch.cuda.synchronize()
        return ts, time.perf_counter() - t0
''')


def test_ast_rules_fire_on_seeded_source():
    findings = analyze_source(SEEDED, "seeded.py")
    assert _rules(findings) == {"A201", "A202", "A203", "A204"}
    assert sum(1 for f in findings if f.rule == "A201") == 2
    for f in findings:
        assert f.line > 0 and f.hint


def test_ast_rules_silent_on_clean_source():
    assert analyze_source(CLEAN, "clean.py") == []


def test_global_rng_draws_fire_in_package_code_only():
    src = "import torch\n\ndef f(n):\n    return torch.randn(n)\n"
    assert _rules(analyze_source(src, "tpudml_torch/x.py")) == {"A202"}
    assert analyze_source(src, "tools/x.py") == []
    seeded = "import torch\n\ndef f(n, g):\n    return torch.randn(n, generator=g)\n"
    assert analyze_source(seeded, "tpudml_torch/x.py") == []


@pytest.mark.parametrize("name", ["p304_port_discipline_fire", "p304_port_discipline_silent"])
def test_p304_findings_equal_jax_s(name):
    pytest.importorskip("jax")
    from tpudml.analysis.ast_pass import analyze_file as jax_analyze_file

    path = str(FIXTURES / "protocol" / f"{name}.py")
    got = [(f.rule, f.line, f.message) for f in analyze_file(path) if f.rule == "P304"]
    want = [(f.rule, f.line, f.message) for f in jax_analyze_file(path) if f.rule == "P304"]
    assert got == want
    assert bool(got) == name.endswith("_fire")


# -------------------------------------------------------------- allowlist


def test_stale_allowlist_entries_detected():
    live = AllowEntry(rule="J111", path="tpudml_torch/optim/*",
                      reason="plain engines omit the sentinel by design")
    live_line = AllowEntry(rule="A201", path="tpudml_torch/tools/*.py", line=12,
                           reason="host-side CLI glue")
    stale = AllowEntry(rule="J105", path="tpudml_torch/nn/old_layer.py",
                       reason="fixed in the rework")
    wrong_line = AllowEntry(rule="A201", path="tpudml_torch/tools/*.py", line=99,
                            reason="drifted line anchor")
    findings = [
        Finding("J111", "no finiteness gate", file="tpudml_torch/optim/optimizers.py",
                line=40),
        Finding("A201", "python if on a tensor", file="tpudml_torch/tools/bench.py", line=12),
    ]
    entries = [live, live_line, stale, wrong_line]
    assert unused_entries(findings, entries) == [stale, wrong_line]
    assert unused_entries(findings, [live, live_line]) == []


def test_committed_allowlist_entries_all_carry_a_reason(tmp_path):
    entries = load_allowlist(ALLOWLIST)
    assert entries and all(e.reason for e in entries)
    bad = tmp_path / "bad.toml"
    bad.write_text('[[allow]]\nrule = "J104"\npath = "x.py"\n')
    with pytest.raises(ValueError, match="reason"):
        load_allowlist(str(bad))
    assert os.path.basename(ALLOWLIST) == "allowlist.toml"
