"""The source lint (the port of ``tpudml/analysis/ast_pass.py``): hazards
the graph pass cannot see, because one recorded step shows only the branch
it took and none of the host code around it.

- A201  a Python ``if``/``while``/``for`` over a tensor value (the result
        of a ``torch.*`` op, or a name bound to one): every such test reads
        the card and stalls the host on it;
- A202  a random draw that repeats another: a ``torch.Generator`` (or the
        global RNG, ``torch.manual_seed``) re-seeded with the same seed
        between draws; or, in package code (``tpudml_torch/``), a draw
        from PyTorch's global RNG, where the port's rule is an explicit
        ``generator=``;
- A203  an epoch loop that re-iterates a loader or sampler without
        calling ``set_epoch``: every epoch replays epoch 0's shuffle;
- A204  host-clock deltas (``time.time``/``perf_counter``) around device
        work with no ``synchronize()`` (the card's, an event's or a
        stream's, or a ``sync`` helper's) and no host read (``.item()``,
        ``.tolist()``, ``.cpu()``, ``float(t)``) in the function: the clock
        measures the launches, not the work;
- P304  port-reservation discipline, as JAX's: a bind-and-hold
        reservation closed before the round's wiring is written, or a
        listening socket that neither escapes the scope nor reaches
        ``close()``.

The checks are name-based heuristics scoped to one function at a time
(module top level counts as a function), tuned for the port's idiom: a
low false-positive rate beats completeness, and what is accepted lands in
the allowlist with its reason.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable

from tpudml_torch.analysis.findings import Finding

#: ``torch.*`` calls whose result is no tensor (A201 leaves them alone).
_NOT_TENSOR = frozenset({
    "is_tensor", "is_floating_point", "is_complex", "is_nonzero", "equal", "allclose",
    "numel", "get_default_dtype", "is_grad_enabled", "is_inference_mode_enabled",
    "promote_types", "result_type", "can_cast", "finfo", "iinfo", "device", "dtype",
    "Size", "Generator", "no_grad", "enable_grad", "inference_mode", "manual_seed",
    "seed", "initial_seed", "get_rng_state", "set_rng_state", "compile", "typename",
    "is_storage", "set_default_dtype", "set_grad_enabled", "are_deterministic_algorithms_enabled",
    "use_deterministic_algorithms", "get_num_threads", "set_num_threads",
})
#: Draws from a random stream (``torch.<name>`` functions, ``Tensor.<name>``
#: methods); each takes ``generator=``.
_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
                    "normal", "poisson", "rand_like", "randn_like", "randint_like"})
_DRAW_METHODS = frozenset({"uniform_", "normal_", "bernoulli_", "random_", "exponential_",
                           "geometric_", "log_normal_", "cauchy_"})
_CLOCKS = frozenset({"time", "perf_counter", "monotonic", "process_time"})
# A call that waits for the card: a synchronize, a host read of a tensor
# (``float(t)`` too), or a helper named for the synchronize it does.
_HOST_READS = frozenset({"synchronize", "item", "tolist", "cpu", "elapsed_time", "float",
                         "sync", "_sync"})


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain ('' when not a plain chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_tensor_call(node: ast.AST) -> bool:
    """A ``torch.<op>(...)`` call that returns a tensor."""
    if not isinstance(node, ast.Call):
        return False
    parts = _attr_chain(node.func).split(".")
    if len(parts) < 2 or parts[0] != "torch":
        return False
    if len(parts) == 2:
        return parts[1] not in _NOT_TENSOR and not parts[1][:1].isupper()
    return parts[1] == "linalg" or parts[1] == "special" or parts[1] == "fft"


def _mentions_torch(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id in ("torch", "cuda"):
            return True
    return False


def _is_package(path: str) -> bool:
    return path.replace(os.sep, "/").startswith("tpudml_torch/")


class _FunctionLinter:
    """Runs every rule over one function-like scope."""

    def __init__(self, path: str, scope_body: list[ast.stmt]):
        self.path = path
        self.body = scope_body
        self.findings: list[Finding] = []
        self._seeds: dict[str, tuple] = {}  # random stream -> (seed, line, drawn since)

    def _emit(self, rule: str, message: str, node: ast.AST) -> None:
        self.findings.append(Finding(
            rule, message, file=self.path, line=getattr(node, "lineno", 0)))

    # -- A201 ---------------------------------------------------------
    def check_tensor_control_flow(self) -> None:
        tensors: set[str] = set()
        for node in self._ordered_nodes():
            if isinstance(node, ast.Assign) and _is_tensor_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tensors.add(tgt.id)
            elif isinstance(node, ast.Assign):
                # any other binding launders the name (float(x), x.item())
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        tensors.discard(tgt.id)
            elif isinstance(node, (ast.If, ast.While)):
                if self._is_tensor(node.test, tensors):
                    self._emit("A201", "branch condition is a tensor value — the test reads "
                                       "the device and stalls the host on it", node)
            elif isinstance(node, ast.For):
                if self._is_tensor(node.iter, tensors):
                    self._emit("A201", "Python for-loop over a tensor — every element is a "
                                       "device→host read", node)

    def _is_tensor(self, expr: ast.AST, tensors: set[str]) -> bool:
        if _is_tensor_call(expr):
            return True
        if isinstance(expr, ast.Name) and expr.id in tensors:
            return True
        if isinstance(expr, ast.Compare):
            return any(self._is_tensor(e, tensors) for e in [expr.left, *expr.comparators])
        if isinstance(expr, ast.BoolOp):
            return any(self._is_tensor(e, tensors) for e in expr.values)
        if isinstance(expr, ast.UnaryOp):
            return self._is_tensor(expr.operand, tensors)
        return False

    # -- A202 ---------------------------------------------------------
    def check_repeated_draws(self) -> None:
        package = _is_package(self.path)
        for node in self._ordered_nodes():
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                seed = self._generator_seed(node.value)
                for tgt in self._assign_names(node):
                    if seed is not None:
                        self._reseed(tgt, seed, node)
                    elif self._makes_generator(node.value):
                        self._seeds.pop(tgt, None)  # a fresh, unseeded generator
                continue
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            leaf = chain.rsplit(".", 1)[-1] if chain else ""
            if leaf == "manual_seed" and node.args:
                recv = chain.rsplit(".", 1)[0] if "." in chain else ""
                stream = "<global>" if recv in ("torch", "torch.cuda", "") else recv
                self._reseed(stream, ast.dump(node.args[0]), node)
                continue
            draw = (chain.startswith("torch.") and leaf in _DRAWS) or (
                isinstance(node.func, ast.Attribute) and leaf in _DRAW_METHODS)
            if not draw:
                continue
            gen = next((kw.value for kw in node.keywords if kw.arg == "generator"), None)
            if gen is None:
                stream = "<global>"
                if package:
                    self._emit("A202", f"{chain or leaf} draws from PyTorch's global RNG — "
                                       f"any other draw or seeding reorders it; pass an "
                                       f"explicit generator=", node)
            else:
                stream = _attr_chain(gen) or ""
            if stream in self._seeds:
                s, line, _ = self._seeds[stream]
                self._seeds[stream] = (s, line, True)

    def _reseed(self, stream: str, seed: str, node: ast.AST) -> None:
        prev = self._seeds.get(stream)
        if prev is not None and prev[0] == seed and prev[2]:
            self._emit("A202", f"random stream '{stream}' re-seeded with the seed it had at "
                               f"line {prev[1]} after drawing from it — the next draws "
                               f"repeat the earlier ones", node)
        self._seeds[stream] = (seed, node.lineno, False)

    @staticmethod
    def _makes_generator(call: ast.Call) -> bool:
        return "Generator" in _attr_chain(call.func)

    @staticmethod
    def _generator_seed(call: ast.Call):
        """``torch.Generator(...).manual_seed(s)``: the dumped seed."""
        f = call.func
        if (isinstance(f, ast.Attribute) and f.attr == "manual_seed" and call.args
                and isinstance(f.value, ast.Call)
                and _attr_chain(f.value.func).endswith("Generator")):
            return ast.dump(call.args[0])
        return None

    @staticmethod
    def _assign_names(node: ast.Assign) -> list[str]:
        names: list[str] = []
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                names.append(tgt.id)
            elif isinstance(tgt, (ast.Tuple, ast.List)):
                names.extend(e.id for e in tgt.elts if isinstance(e, ast.Name))
        return names

    # -- A203 ---------------------------------------------------------
    def check_set_epoch(self) -> None:
        for node in self._ordered_nodes():
            if not isinstance(node, ast.For):
                continue
            tgt = node.target
            if not (isinstance(tgt, ast.Name) and "epoch" in tgt.id.lower()):
                continue
            iterates_loader = False
            calls_set_epoch = False
            for sub in ast.walk(node):
                if isinstance(sub, ast.For) and sub is not node:
                    name = ""
                    if isinstance(sub.iter, ast.Name):
                        name = sub.iter.id
                    elif isinstance(sub.iter, ast.Call):
                        name = _attr_chain(sub.iter.func)
                    if "loader" in name.lower() or "sampler" in name.lower():
                        iterates_loader = True
                if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "set_epoch"):
                    calls_set_epoch = True
            if iterates_loader and not calls_set_epoch:
                self._emit("A203", "epoch loop iterates a loader without set_epoch(epoch) — "
                                   "every epoch replays the same shuffle order", node)

    # -- A204 ---------------------------------------------------------
    def check_timing(self) -> None:
        clock_calls: list[ast.Call] = []
        reads = False
        for node in self._ordered_nodes():
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            leaf = chain.rsplit(".", 1)[-1] if chain else ""
            if not chain and isinstance(node.func, ast.Attribute):
                leaf = node.func.attr
            if leaf in _CLOCKS and chain.split(".")[0] in ("time", leaf):
                clock_calls.append(node)
            if leaf in _HOST_READS:
                reads = True
        if len(clock_calls) >= 2 and not reads:
            self._emit("A204", "host-clock delta with no synchronize() or host read in scope "
                               "— kernels run asynchronously, so this times the launches, "
                               "not the device work", clock_calls[1])

    # -- P304 ---------------------------------------------------------
    def check_port_discipline(self) -> None:
        """JAX's two reservation-discipline hazards, as JAX checks them."""
        created: set[str] = set()
        listening: set[str] = set()
        closed: set[str] = set()
        escaped: set[str] = set()
        listen_nodes: dict[str, ast.AST] = {}
        aliases: dict[str, str] = {}
        hold_close: ast.AST | None = None
        wiring_line: int | None = None

        def names_in(expr: ast.AST) -> Iterable[str]:
            for n in ast.walk(expr):
                if isinstance(n, ast.Name):
                    yield n.id

        for node in self._ordered_nodes():
            if (isinstance(node, ast.For) and isinstance(node.target, ast.Name)
                    and isinstance(node.iter, ast.Name)):
                aliases[node.target.id] = node.iter.id
            if isinstance(node, ast.Assign):
                plain = all(isinstance(t, ast.Name) for t in node.targets)
                if plain and len(node.targets) == 1 and isinstance(node.value, ast.Call):
                    leaf = _attr_chain(node.value.func).rsplit(".", 1)[-1]
                    if leaf == "socket":
                        created.add(node.targets[0].id)
                        continue
                if not plain and not isinstance(node.value, ast.Call):
                    escaped.update(names_in(node.value))
                elif plain and isinstance(node.value, ast.Name):
                    escaped.add(node.value.id)
            elif isinstance(node, (ast.Return, ast.Yield)):
                if node.value is not None:
                    escaped.update(names_in(node.value))
            elif isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                leaf = chain.rsplit(".", 1)[-1] if chain else ""
                recv = chain.rsplit(".", 1)[0] if "." in chain else ""
                if leaf == "listen" and recv:
                    listening.add(recv)
                    listen_nodes.setdefault(recv, node)
                elif leaf == "close" and recv:
                    closed.add(recv)
                    base = aliases.get(recv, recv)
                    if hold_close is None and re.search(r"hold|reserv", base, re.IGNORECASE):
                        hold_close = node
                if "wiring" in leaf.lower() and wiring_line is None:
                    wiring_line = node.lineno
                for arg in (*node.args, *(kw.value for kw in node.keywords)):
                    escaped.update(names_in(arg))

        for name in sorted((created & listening) - closed - escaped):
            self._emit("P304", f"listener socket '{name}' is bound and listening but never "
                               f"reaches close() and never escapes this scope — leaked on "
                               f"any error path (close in a finally, or hand it off)",
                       listen_nodes[name])
        if hold_close is not None and wiring_line is not None and hold_close.lineno < wiring_line:
            self._emit("P304", "bind-and-hold port reservation released before the round's "
                               "wiring is committed — a squatter can take the port between "
                               "release and spawn; keep the hold until write_wiring returns",
                       hold_close)

    # ------------------------------------------------------------------
    def _ordered_nodes(self) -> list:
        """Every node in this scope in source order, not descending into
        nested function/class definitions (they get their own linter)."""
        cached = getattr(self, "_nodes", None)
        if cached is not None:
            return cached
        out: list[ast.AST] = []

        def visit(n: ast.AST) -> None:
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                                      ast.Lambda)):
                    continue
                out.append(child)
                visit(child)

        for stmt in self.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            out.append(stmt)
            visit(stmt)
        out.sort(key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0)))
        self._nodes = out
        return out

    def run(self, torch_in_scope: bool) -> list[Finding]:
        self.check_tensor_control_flow()
        self.check_repeated_draws()
        self.check_set_epoch()
        self.check_port_discipline()
        if torch_in_scope:
            self.check_timing()
        return self.findings


def _scopes(tree: ast.Module):
    """Yield (body, node for the torch check) for the module and each def."""
    yield tree.body, tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.body, node


def analyze_source(source: str, path: str) -> list[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("J100", f"file failed to parse: {e}", file=path, line=e.lineno or 0)]
    findings: list[Finding] = []
    for body, scope_node in _scopes(tree):
        findings.extend(_FunctionLinter(path, body).run(_mentions_torch(scope_node)))
    return findings


def analyze_file(path: str) -> list[Finding]:
    rel = os.path.relpath(path, os.getcwd())
    rel = path if rel.startswith("..") else rel
    with open(path, "r", encoding="utf-8") as f:
        return analyze_source(f.read(), rel)


def iter_python_files(roots: list[str]) -> list[str]:
    files: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            files.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".git", "_build")]
            files.extend(os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py"))
    return sorted(files)


def analyze_tree(roots: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(roots):
        findings.extend(analyze_file(path))
    return findings
